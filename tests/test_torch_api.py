"""The port's public surface covers the JAX package's: every name in
``repro.__all__`` is in ``repro_torch.__all__`` and resolves there (the
JAX package exports no Pallas-only name at its top level; those stay out),
and so do the training names."""
import repro
import repro_torch

PALLAS_ONLY = {"default_interpret", "tcam_match_pallas",
               "tcam_match_packed_pallas"}
TRAINING = {"loss_fn", "AdamWConfig", "OptState", "adamw_init",
            "adamw_update", "cosine_schedule", "global_norm",
            "quantize_int8", "dequantize_int8", "ef_init", "ef_compress",
            "TrainState", "init_train_state", "build_train_step",
            "build_prefill_step", "build_decode_step", "CheckpointManager",
            "restore_resharded", "FaultTolerantLoop", "StragglerMonitor",
            "train_state_from_arrays", "train_state_to_arrays"}


def test_port_exports_every_public_name_of_the_jax_package():
    missing = set(repro.__all__) - PALLAS_ONLY - set(repro_torch.__all__)
    assert not missing, sorted(missing)
    assert not PALLAS_ONLY & set(repro_torch.__all__)


def test_every_exported_name_resolves():
    for name in set(repro_torch.__all__) | TRAINING:
        assert name in repro_torch.__all__, name
        assert getattr(repro_torch, name) is not None, name


def test_subpackages_export_as_the_jax_package_does():
    from repro import serve as jax_serve
    from repro_torch import serve
    assert set(jax_serve.__all__) <= set(serve.__all__)
    assert serve.PromotionReport is repro_torch.PromotionReport

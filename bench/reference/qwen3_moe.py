"""The reference of ``model_type`` qwen3_moe (Qwen3-MoE): the decoder of
``transformer`` with per-head RMSNorm on q and k and a softmax router over
the experts, from a configuration file's published keys and its ``run``
section (capacity factor and token groups)."""
from .transformer import *  # noqa: F401,F403
from .transformer import Spec


def spec(conf: dict) -> Spec:
    run = conf["run"]
    return Spec(d=conf["hidden_size"], heads=conf["num_attention_heads"],
                kv_heads=conf["num_key_value_heads"],
                head_dim=conf["head_dim"], vocab=conf["vocab_size"],
                layers=conf["num_hidden_layers"], ffn="moe",
                ffn_dim=conf["moe_intermediate_size"],
                experts=conf["num_experts"],
                top_k=conf["num_experts_per_tok"], norm="rms",
                eps=conf["rms_norm_eps"], theta=conf["rope_theta"],
                qk_norm=True, tied=conf["tie_word_embeddings"],
                capacity_factor=run["capacity_factor"],
                groups=run["moe_groups"])

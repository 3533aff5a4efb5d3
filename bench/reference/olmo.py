"""The reference of ``model_type`` olmo (OLMo): the decoder of
``transformer`` with non-parametric LayerNorm, SwiGLU and tied
embeddings, from a configuration file's published keys."""
from .transformer import *  # noqa: F401,F403
from .transformer import Spec


def spec(conf: dict) -> Spec:
    d = conf["d_model"]
    return Spec(d=d, heads=conf["n_heads"], kv_heads=conf["n_heads"],
                head_dim=d // conf["n_heads"], vocab=conf["embedding_size"],
                layers=conf["n_layers"], ffn="mlp",
                ffn_dim=conf["mlp_ratio"] * d // 2, experts=0, top_k=0,
                norm="nonparam", eps=conf["layer_norm_eps"],
                theta=float(conf["rope_theta"]), qk_norm=False,
                tied=conf["weight_tying"])

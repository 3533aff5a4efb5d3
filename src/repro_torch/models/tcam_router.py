"""A decision-tree MoE router compiled to a TCAM LUT with the paper's DT-HW
compiler and evaluated on the device as a ternary match.

Pipeline:
  1. Train a CART tree mapping (a projection of) hidden states -> expert id
     (e.g. distilling a trained softmax router, or from k-means clusters).
  2. ``compile_router`` runs the paper's parse/reduce/encode pipeline and
     lowers the LUT to flat tensors on the device:
       bit_feat / bit_thr / bit_const — input encoding is pure comparisons
         (bit i of feature f's code = x[f] > th_{T-1-i}; trailing bit = 1),
       is0 / is1 — bitplanes of the encoded LUT rows,
       classes — expert id per row.
  3. ``route_tcam`` evaluates the match: one (T, W) x (W, R) f32 product
     pair and an argmin over rows — the paper's massively-parallel search,
     as the MoE router.

The TCAM router is top-1 (a DT predicts one class).  It is a selectable
``router="tcam_dt"`` config option, reached through
``moe_ffn(..., router_bits=compile_router(tree))``.  It does not go through
the bitplane match kernel: that kernel reports the first surviving row,
which differs from ``argmin`` where no row matches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.cart import DecisionTree
from ..core.encode import encode_table, feature_thresholds
from ..core.lut import bitplanes
from ..core.reduce import reduce_tree
from ..device import DeviceLike, resolve_device

__all__ = ["compile_router", "route_tcam"]


def compile_router(tree: DecisionTree, *, device: DeviceLike = None) -> dict:
    """Compile a CART tree into flat tensors on ``device`` (default: the
    card) for TCAM routing."""
    dev = resolve_device(device)
    table = reduce_tree(tree)
    lut = encode_table(table)
    ths = feature_thresholds(table)

    bit_feat, bit_thr, bit_const = [], [], []
    for f_idx, th in enumerate(ths):
        t_i = th.size
        # feature code has t_i + 1 bits; bit i (left->right) compares against
        # th[t_i - 1 - i]; the last bit is constant 1.
        for i in range(t_i):
            bit_feat.append(f_idx)
            bit_thr.append(float(th[t_i - 1 - i]))
            bit_const.append(False)
        bit_feat.append(0)
        bit_thr.append(0.0)
        bit_const.append(True)
    is0, is1 = bitplanes(lut.cells)
    arrays = {
        "bit_feat": np.array(bit_feat, np.int64),
        # f32, as the reference: ``x > thr`` then compares the same bits
        "bit_thr": np.array(bit_thr, np.float32),
        "bit_const": np.array(bit_const, bool),
        "is0": is0.astype(np.float32),
        "is1": is1.astype(np.float32),
        "classes": lut.classes.astype(np.int64),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def route_tcam(x: torch.Tensor, bits: dict) -> torch.Tensor:
    """(T, D) hidden states -> (T,) expert ids via TCAM match.

    Encoding + match are exactly the paper's semantics; by DT construction
    every input matches exactly one row (``torch.argmin`` returns the first
    minimal row, as ``jnp.argmin``)."""
    # gather, then cast: the same values as the reference's cast-then-gather
    # without an f32 copy of every hidden-state column
    vals = x[:, bits["bit_feat"]].float()                    # (T, W)
    xbits = torch.where(bits["bit_const"][None, :], 1.0,
                        (vals > bits["bit_thr"][None, :]).float())
    mism = xbits @ bits["is0"].T + (1.0 - xbits) @ bits["is1"].T
    row = torch.argmin(mism, dim=-1)                         # zero-mismatch row
    return bits["classes"][row]

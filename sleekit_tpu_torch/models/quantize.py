"""Packed serving head (port of ``pack_lm_head`` from
``sleekit_tpu/models/quantize.py``; the calibrate/quantize drivers come
with the quantizer, ROADMAP queue 1, item 11)."""

from __future__ import annotations

from sleekit_tpu_torch.codebooks import UniformCodebook
from sleekit_tpu_torch.models.transformer import TransformerConfig
from sleekit_tpu_torch.ops.pack import PackedLinear, pack_quantized
from sleekit_tpu_torch.scaling import compute_non_saturating_scaling


def pack_lm_head(cfg: TransformerConfig, params, nbits: int = 8):
    """Inject a packed serving unembed head: round-to-nearest with
    per-vocab-channel non-saturating scales (int8 'int8' layout by
    default; padded vocab columns get scale 0). The tied embedding gather
    keeps the dense table. Packs on the device the weights live on."""
    params = dict(params)
    if "lm_head" in params and not isinstance(params["lm_head"],
                                              PackedLinear):
        W = params["lm_head"]["kernel"].T          # (V, E)
    else:
        W = params["embed"]["tokens"]               # (V, E) tied
        if "project_out" in params["embed"]:
            raise ValueError("pack_lm_head does not support project_out "
                             "models (OPT-350M); unembed stays dense")
    W = W.float()
    cb = UniformCodebook(2 ** nbits, -1.0, 1.0)
    scale = compute_non_saturating_scaling(W, cb)   # per vocab channel
    Q = cb(W / scale[:, None]) * scale[:, None]
    params["lm_head"] = pack_quantized(Q, scale, cb)
    return params

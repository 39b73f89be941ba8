"""Random packed models for smoke runs and measurements (port of
``random_packed_params``/``_fast_packed_linear`` from
``sleekit_tpu/models/fake_quant.py``, 'pair' layout).

Every quantizable linear is built straight from numpy random bits on the
host: uniform random words ARE uniform random indices for power-of-two
widths, so no dense kernel is ever materialized and no pack step runs.
Only the packed result goes to the device. The seed is a numpy integer
seed; the JAX package derives its numpy seed from a JAX key, which the
port cannot reproduce.
"""

from __future__ import annotations

import numpy as np
import torch

from sleekit_tpu_torch.codebooks import UniformCodebook
from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.models.transformer import (
    TransformerConfig, fuse_qkv_params, init_params)
from sleekit_tpu_torch.ops.pack import (
    PackedLinear, affine_from_lut, bits_for_codebook, pair_group,
    pair_planes)


def _fast_packed_linear(rng: np.random.Generator, in_features: int,
                        out_features: int, codebook, bias: bool,
                        device: torch.device,
                        layout: str = "pair") -> PackedLinear:
    """Random 'pair' PackedLinear from random words; K rounds up to the
    pair tile."""
    if layout != "pair":
        raise NotImplementedError(
            f"random {layout!r} weights are not ported yet (ROADMAP queue 1, "
            "item 13: the other serving layouts)")
    nbits = bits_for_codebook(len(codebook))
    if len(codebook) != 2 ** nbits:
        raise NotImplementedError(
            "random packed weights need a power-of-two codebook")
    hp, pg = pair_planes(nbits), pair_group(nbits)
    kw = -(-in_features // (2 * pg * hp)) * pg
    words = rng.integers(-2 ** 31, 2 ** 31, (kw, out_features),
                         dtype=np.int64).astype(np.int32)
    scale = (0.02 * (1.0 + 0.1 * rng.random(out_features))).astype(np.float32)
    lut = codebook.values
    return PackedLinear(
        packed=torch.from_numpy(words).to(device),
        scale=torch.from_numpy(scale).to(device),
        lut=lut.to(device),
        bias=(torch.zeros(out_features, dtype=torch.float32, device=device)
              if bias else None),
        in_features=in_features, out_features=out_features, nbits=nbits,
        affine=affine_from_lut(lut), layout=layout)


def random_packed_params(cfg: TransformerConfig, seed: int = 0,
                         codebook=None, fuse_qkv: bool = False,
                         layout: str = "pair", device="cuda"):
    """Random params with every quantizable linear a random packed one.
    Returns (params, codebook). ``fuse_qkv`` applies the serving-time
    q|k|v (and gate|up) fusion."""
    dev = resolve_device(device)
    codebook = codebook or UniformCodebook(16, -1.0, 1.0)
    rng = np.random.default_rng(seed)

    def factory(d_in, d_out, bias=True):
        return _fast_packed_linear(rng, d_in, d_out, codebook, bias, dev,
                                   layout=layout)

    params = init_params(cfg, seed, device=dev, linear_factory=factory)
    if fuse_qkv:
        params = fuse_qkv_params(cfg, params)
    return params, codebook

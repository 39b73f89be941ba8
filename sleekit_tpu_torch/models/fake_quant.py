"""Random packed models for smoke runs and measurements (port of
``random_packed_params``/``_fast_packed_linear`` from
``sleekit_tpu/models/fake_quant.py``; layouts 'pair', 'pair3', 'pair3x'
and 'plane').

Every quantizable linear is built straight from numpy random bits on the
host: uniform random words ARE uniform random indices for power-of-two
codebooks, so no dense kernel is ever materialized and no pack step runs.
Only the packed result goes to the device. A codebook whose size is not a
power of two gets a real pack of random indices instead. The seed is a
numpy integer seed; the JAX package derives its numpy seed from a JAX
key, which the port cannot reproduce.
"""

from __future__ import annotations

import numpy as np
import torch

from sleekit_tpu_torch.codebooks import UniformCodebook
from sleekit_tpu_torch.device import resolve_device
from sleekit_tpu_torch.models.transformer import (
    TransformerConfig, fuse_qkv_params, init_params)
from sleekit_tpu_torch.ops.pack import (
    PAIR3_TILE, PAIR3_WORDS, PAIR3X_GROUP, PAIR3X_P4_WORDS, PAIR3X_WORDS,
    PLANE_GROUP, PackedLinear, affine_from_lut, bits_for_codebook,
    pack_indices, pair_group, pair_planes, vals_per_word)


def _fast_packed_linear(rng: np.random.Generator, in_features: int,
                        out_features: int, codebook, bias: bool,
                        device: torch.device,
                        layout: str = "pair") -> PackedLinear:
    """Random PackedLinear from random words; K rounds up to the layout's
    tile. 'pair3x' needs K % 512 == 0 and falls back to 'pair3'
    otherwise, as in the JAX package."""
    nbits = bits_for_codebook(len(codebook))
    if layout in ("pair3", "pair3x") and nbits != 3:
        raise ValueError(f"layout {layout!r} takes a 3-bit codebook")
    if layout == "pair3x" and in_features % PAIR3X_GROUP:
        layout = "pair3"
    if layout == "pair3x":
        kw = in_features // PAIR3X_GROUP * PAIR3X_WORDS
    elif layout == "pair3":
        kw = -(-in_features // PAIR3_TILE) * PAIR3_WORDS
    elif layout == "pair":
        hp, pg = pair_planes(nbits), pair_group(nbits)
        kw = -(-in_features // (2 * pg * hp)) * pg
    elif layout == "plane":
        kw = -(-in_features // (PLANE_GROUP * vals_per_word(nbits))
               ) * PLANE_GROUP
    else:
        raise ValueError(f"random {layout!r} weights: use 'pair', 'pair3', "
                         "'pair3x' or 'plane'")
    if len(codebook) == 2 ** nbits:
        words = rng.integers(-2 ** 31, 2 ** 31, (kw, out_features),
                             dtype=np.int64).astype(np.int32)
        if layout == "pair3x":
            # The 4-bit fields hold 3-bit indices: their top bit is 0.
            groups = words.reshape(-1, PAIR3X_WORDS, out_features)
            groups[:, :PAIR3X_P4_WORDS] &= 0x77777777
    else:
        # Random bits would make out-of-range indices.
        idx = rng.integers(0, len(codebook), (in_features, out_features))
        words = pack_indices(torch.from_numpy(idx), nbits,
                             layout=layout).numpy()
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

"""Packed sub-byte weight format (port of ``sleekit_tpu/ops/pack.py``).

The format is the contract between the two packages: words packed here are
bit-identical to the JAX package's. Weights live in serving layout (K, N);
indices pack into int32 words along K. The words carry raw bit patterns,
and torch's ``>>`` on int32 is an arithmetic shift, so every unpack widens
to int64 and masks to the low 32 bits first.

Layouts: ``linear`` (interchange), ``plane`` (plane-major tiles, kernels
K8/K9), ``pair`` (the bf16-pair layout of kernel K1), ``pair3`` (3-bit
split into 2-bit and 1-bit pair planes, K7), ``pair3x`` (3-bit mixed
4-bit-field and pair3 groups, K6) and ``int8`` (signed bytes, K2). The
tensor-parallel row-sharding format (``split_packed_k``,
``localize_packed_shard``) is what ``parallel/`` serves row-parallel
linears in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# 'plane': within each tile of PLANE_GROUP*vpw K rows, word row g bit
# field j holds K row j*PLANE_GROUP + g.
PLANE_GROUP = 32
PAIR_GROUP = 32
# 'pair3': per 256-row tile, 16 words of 2-bit low planes (a pair tile with
# 8 planes of 16 word rows) then 8 words of 1-bit high planes (16 planes of
# 8 word rows); idx = lo + 4*hi.
PAIR3_TILE = 256
PAIR3_WORDS = 24
PAIR3_LO_WORDS = 16
# 'pair3x': per 512-row group, its first 256 rows as 4-bit fields in one
# pair tile (32 words, top bit of each field 0), its last 256 as one pair3
# tile (24 words).
PAIR3X_GROUP = 512
PAIR3X_WORDS = 56
PAIR3X_P4_WORDS = 32
LAYOUTS = ("linear", "plane", "pair", "pair3", "pair3x", "int8")


def _check_layout(layout: str, nbits: int) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if layout in ("pair3", "pair3x") and nbits != 3:
        raise ValueError(f"layout {layout!r} holds 3-bit indices, not "
                         f"{nbits}-bit")


def affine_from_lut(lut) -> Optional[Tuple[float, float]]:
    """(step, zero) if the LUT is an affine grid (uniform codebook), else
    None."""
    if isinstance(lut, torch.Tensor):
        lut = lut.detach().cpu().numpy()
    lut = np.asarray(lut)
    if lut.size < 2:
        return None
    diffs = np.diff(lut)
    step = float(diffs[0])
    if np.allclose(diffs, step, rtol=1e-5, atol=1e-7):
        return (step, float(lut[0]))
    return None


def bits_for_codebook(codebook_size: int) -> int:
    """Smallest packing width holding indices 0..k-1 (1..8 bits)."""
    nbits = max(1, int(np.ceil(np.log2(codebook_size))))
    if nbits > 8:
        raise ValueError(f"codebook size {codebook_size} too large to pack")
    return nbits


def vals_per_word(nbits: int) -> int:
    """Sub-elements per word: 32/nbits, except 10 for 3-bit."""
    if nbits == 3:
        return 10
    if 32 % nbits != 0:
        raise ValueError(f"unsupported pack width {nbits}")
    return 32 // nbits


def pair_planes(nbits: int) -> int:
    """Bit planes per 16-bit half in the 'pair' layout: floor(16/nbits)."""
    return 16 // nbits


def pair_group(nbits: int) -> int:
    """Word rows per pair tile: doubled when the plane count is odd."""
    return PAIR_GROUP * (2 if pair_planes(nbits) % 2 else 1)


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _pair_words(tiles: torch.Tensor, hp: int, pg: int,
                bits: int) -> torch.Tensor:
    """(T, 2*pg*hp, N) int64 fields -> (T, pg, N) words: word row p carries
    K row ``j*(2*pg) + 2*p + h`` of its tile in bits ``[16*h + bits*j,
    +bits)``."""
    t, _, n = tiles.shape
    split = tiles.reshape(t, hp, pg, 2, n)   # (tile, j, p, h, n)
    shifts = (16 * torch.arange(2, device=tiles.device)[None, :]
              + bits * torch.arange(hp, device=tiles.device)[:, None])
    return (split << shifts[None, :, None, :, None]).sum(dim=(1, 3))


def _pair_fields(words: torch.Tensor, hp: int, bits: int) -> torch.Tensor:
    """Inverse of :func:`_pair_words`: (T, pg, N) words (int64, low 32
    bits) -> (T, 2*pg*hp, N) fields."""
    t, pg, n = words.shape
    shifts = (16 * torch.arange(2, device=words.device)[None, :]
              + bits * torch.arange(hp, device=words.device)[:, None])
    sub = (words[:, None, :, None, :] >> shifts[None, :, None, :, None]) & (
        (1 << bits) - 1)                      # (tile, j, p, h, n)
    return sub.reshape(t, 2 * pg * hp, n)


def _pad_rows(idx: torch.Tensor, bk: int) -> torch.Tensor:
    k = idx.shape[0]
    return torch.nn.functional.pad(idx, (0, 0, 0, -(-k // bk) * bk - k))


def _pair3_tiles(idx: torch.Tensor) -> torch.Tensor:
    """(T, 256, N) 3-bit indices -> (T, 24, N) 'pair3' words."""
    return torch.cat([_pair_words(idx & 3, 8, 16, 2),
                      _pair_words(idx >> 2, 16, 8, 1)], dim=1)


def _pair3_fields(words: torch.Tensor) -> torch.Tensor:
    """(T, 24, N) 'pair3' words -> (T, 256, N) indices."""
    return (_pair_fields(words[:, :PAIR3_LO_WORDS], 8, 2)
            + 4 * _pair_fields(words[:, PAIR3_LO_WORDS:], 16, 1))


def pack_indices(idx: torch.Tensor, nbits: int,
                 layout: str = "linear") -> torch.Tensor:
    """Pack (K, N) integer indices into (kw, N) int32 words (int8 bytes for
    the 'int8' layout).

    'linear': word g packs K rows g*vpw..(g+1)*vpw-1.
    'plane': tiles of PLANE_GROUP word rows; word row g, field j of a tile
    holds its K row ``j*PLANE_GROUP + g``.
    'pair': tiles of ``pair_group`` word rows; word row p of a tile carries
    K row ``j*(2*pg) + 2*p + h`` in bits ``[16*h + nbits*j, +nbits)``.
    'pair3': 256-row tiles of 24 words (see PAIR3_*).
    'pair3x': 512-row groups of 56 words (see PAIR3X_*); K % 512 == 0.
    'int8': signed bytes ``idx - 128``, K padded to 32 and N to 1024 with
    index 128 (stored 0) at pack time.
    """
    if idx.ndim != 2:
        raise ValueError("pack_indices takes a (K, N) index matrix")
    _check_layout(layout, nbits)
    k, n = idx.shape
    idx = idx.to(torch.int64)
    if layout == "int8":
        k_pad = -(-k // 32) * 32
        n_pad = -(-n // 1024) * 1024
        idx = torch.nn.functional.pad(idx, (0, n_pad - n, 0, k_pad - k),
                                      value=128)
        return (idx - 128).to(torch.int8)
    if layout == "pair":
        hp, pg = pair_planes(nbits), pair_group(nbits)
        tiles = _pad_rows(idx, 2 * pg * hp).reshape(-1, 2 * pg * hp, n)
        return _to_int32_bits(_pair_words(tiles, hp, pg, nbits).reshape(-1,
                                                                         n))
    if layout == "pair3":
        tiles = _pad_rows(idx, PAIR3_TILE).reshape(-1, PAIR3_TILE, n)
        return _to_int32_bits(_pair3_tiles(tiles).reshape(-1, n))
    if layout == "pair3x":
        if k % PAIR3X_GROUP:
            raise ValueError(f"pair3x requires K % {PAIR3X_GROUP} == 0 (got "
                             f"{k}); use layout='pair3' for other K")
        groups = idx.reshape(-1, 2, 256, n)
        words = torch.cat([_pair_words(groups[:, 0], 4, 32, 4),
                           _pair3_tiles(groups[:, 1])], dim=1)
        return _to_int32_bits(words.reshape(-1, n))
    vpw = vals_per_word(nbits)
    if layout == "linear":
        grouped = _pad_rows(idx, vpw).reshape(-1, vpw, n)
    else:
        # (tiles, vpw, PLANE_GROUP, n): axis 1 is the bit plane
        tiles = _pad_rows(idx, PLANE_GROUP * vpw).reshape(-1, vpw,
                                                          PLANE_GROUP, n)
        grouped = tiles.transpose(1, 2).reshape(-1, vpw, n)
    shifts = (torch.arange(vpw, device=idx.device) * nbits)[None, :, None]
    return _to_int32_bits((grouped << shifts).sum(dim=1))


def unpack_indices(packed: torch.Tensor, nbits: int, k: int,
                   layout: str = "linear") -> torch.Tensor:
    """Inverse of :func:`pack_indices`; returns (k, N) int32 indices."""
    if packed.ndim != 2:
        raise ValueError("unpack_indices takes a (kw, N) word matrix")
    _check_layout(layout, nbits)
    kw, n = packed.shape
    if layout == "int8":
        return packed[:k].to(torch.int32) + 128
    words = packed.to(torch.int64) & 0xFFFFFFFF
    if layout == "pair":
        hp, pg = pair_planes(nbits), pair_group(nbits)
        full = _pair_fields(words.reshape(-1, pg, n), hp, nbits)
    elif layout == "pair3":
        full = _pair3_fields(words.reshape(-1, PAIR3_WORDS, n))
    elif layout == "pair3x":
        groups = words.reshape(-1, PAIR3X_WORDS, n)
        full = torch.cat([_pair_fields(groups[:, :PAIR3X_P4_WORDS], 4, 4),
                          _pair3_fields(groups[:, PAIR3X_P4_WORDS:])], dim=1)
    else:
        vpw = vals_per_word(nbits)
        shifts = (torch.arange(vpw, device=packed.device)
                  * nbits)[None, :, None]
        full = (words[:, None, :] >> shifts) & ((1 << nbits) - 1)
        if layout == "plane":
            # plane j of tile t holds K rows t*bk + j*PLANE_GROUP + g
            full = full.reshape(-1, PLANE_GROUP, vpw, n).transpose(1, 2)
    return full.reshape(-1, n)[:k].to(torch.int32)


@dataclasses.dataclass
class PackedLinear:
    """A packed weight-only-quantized linear layer: y = x @ deq(W) + b,
    ``deq(W)[k, n] = lut[idx[k, n]] * scale[n]``.

    The JAX class's ``layer_sel`` has no counterpart: per-layer weights are
    a Python list, and a layer of a contiguous stacked (L, kw, N) tensor is
    the zero-copy view ``packed[l]``.
    """

    packed: torch.Tensor          # (kw, N) int32 words, or int8 bytes
    scale: torch.Tensor           # (N,) f32
    lut: torch.Tensor             # (codebook_size,) f32
    bias: Optional[torch.Tensor]  # (N,) f32 or None
    in_features: int
    out_features: int
    nbits: int
    affine: Optional[Tuple[float, float]] = None
    layout: str = "linear"
    # >1: the K axis is split into this many contiguous chunks, each packed
    # on its own (its own tile padding) and concatenated along word rows:
    # the tensor-parallel row-sharding format (split_packed_k). Matmuls
    # take k_splits == 1 matrices; localize_packed_shard makes one of a
    # rank's chunk.
    k_splits: int = 1

    @property
    def vpw(self) -> int:
        return vals_per_word(self.nbits)

    def memory_bytes(self) -> int:
        return int(self.packed.numel() * self.packed.element_size()
                   + self.scale.numel() * 4 + self.lut.numel() * 4
                   + (0 if self.bias is None else self.bias.numel() * 4))

    def dequantize(self) -> torch.Tensor:
        """Dense f32 (K, N) weights (reference semantics)."""
        if self.k_splits > 1:
            kw = self.packed.shape[0] // self.k_splits
            k_local = self.in_features // self.k_splits
            idx = torch.cat([unpack_indices(
                self.packed[i * kw:(i + 1) * kw], self.nbits, k_local,
                layout=self.layout) for i in range(self.k_splits)])
        else:
            idx = unpack_indices(self.packed, self.nbits, self.in_features,
                                 layout=self.layout)
        idx = idx[:, :self.out_features]  # int8 layout pads N at pack time
        return self.lut[idx.long()] * self.scale[None, :]


def split_packed_k(p: PackedLinear, n: int) -> PackedLinear:
    """Re-pack for tensor-parallel ROW sharding: split K into ``n``
    contiguous chunks, pack each on its own (its own tile padding, so every
    layout splits cleanly) and concatenate them along word rows. The word
    rows then cut into ``n`` equal parts, each a well-formed (K/n, N)
    packing; the partial products sum exactly, since the affine fold
    ``b*sum(x_chunk)`` and the per-channel scale are linear in the
    chunks. A 'pair3x' matrix whose chunks are not a multiple of 512 rows
    re-packs as 'pair3'. The words are the JAX package's, bit for bit."""
    if n == 1:
        return p
    if p.k_splits != 1:
        raise ValueError(f"already split (k_splits={p.k_splits})")
    if p.in_features % n:
        raise ValueError(f"K={p.in_features} not divisible by {n} shards")
    k_local = p.in_features // n
    idx = unpack_indices(p.packed, p.nbits, p.in_features, layout=p.layout)
    layout = p.layout
    if layout == "pair3x" and k_local % PAIR3X_GROUP:
        layout = "pair3"
    chunks = [pack_indices(idx[i * k_local:(i + 1) * k_local], p.nbits,
                           layout=layout) for i in range(n)]
    return dataclasses.replace(p, packed=torch.cat(chunks), k_splits=n,
                               layout=layout)


def localize_packed_shard(p: PackedLinear, n: int,
                          row_parallel: bool) -> PackedLinear:
    """The static fields of one rank's shard of ``p`` (its arrays already
    cut): a row-parallel shard of a :func:`split_packed_k` matrix becomes
    an ordinary (K/n, N) packed linear; a column-parallel one keeps K and
    has N/n outputs."""
    if n == 1:
        return p
    if row_parallel:
        if p.k_splits != n:
            raise ValueError(f"a row-parallel PackedLinear must be "
                             f"split_packed_k({n}) first (k_splits="
                             f"{p.k_splits})")
        return dataclasses.replace(p, in_features=p.in_features // n,
                                   k_splits=1)
    if p.out_features % n:
        raise ValueError(f"N={p.out_features} not divisible by {n} shards")
    return dataclasses.replace(p, out_features=p.out_features // n)


def concat_packed(pls) -> PackedLinear:
    """Concatenate PackedLinears along the output (N) axis (serving-time
    q|k|v fusion; exact because scales are per output channel)."""
    first = pls[0]
    for p in pls[1:]:
        if (p.in_features, p.nbits, p.layout) != (
                first.in_features, first.nbits, first.layout):
            raise ValueError("concat_packed needs equal in_features, nbits "
                             "and layout")
        if not torch.allclose(p.lut.cpu(), first.lut.cpu()):
            raise ValueError("concat_packed needs one shared LUT")
    packed = torch.cat([p.packed for p in pls], dim=1)
    scale = torch.cat([p.scale for p in pls])
    if all(p.bias is None for p in pls):
        bias = None
    else:
        bias = torch.cat([
            p.bias if p.bias is not None
            else torch.zeros(p.out_features, dtype=torch.float32,
                             device=p.scale.device) for p in pls])
    return PackedLinear(
        packed=packed, scale=scale, lut=first.lut, bias=bias,
        in_features=first.in_features,
        out_features=sum(p.out_features for p in pls),
        nbits=first.nbits, affine=first.affine, layout=first.layout)


def pack_quantized(weight_q: torch.Tensor, scale: torch.Tensor, codebook,
                   bias: Optional[torch.Tensor] = None,
                   layout: str = "auto") -> PackedLinear:
    """Pack a quantizer output (out, in) on the per-channel scaled codebook
    grid into serving format. 'auto' picks as the JAX package does: for an
    affine codebook 'pair3x' at 3 bits when K % 512 == 0, else 'pair3';
    'pair' up to 7 bits and 'int8' at 8; 'plane' for table codebooks."""
    out_f, in_f = weight_q.shape
    normalized = weight_q / scale[:, None]
    idx = codebook.quantize_index(normalized).to(torch.int32)
    lut = codebook.values.to(device=weight_q.device, dtype=torch.float32)
    nbits = bits_for_codebook(int(lut.shape[0]))
    if layout == "auto":
        aff = affine_from_lut(lut) is not None
        layout = ("pair3x" if aff and nbits == 3
                  and in_f % PAIR3X_GROUP == 0
                  else "pair3" if aff and nbits == 3
                  else "pair" if aff and nbits <= 7
                  else "int8" if aff and nbits == 8 else "plane")
    packed = pack_indices(idx.T, nbits, layout=layout)
    scale = scale.to(torch.float32)
    if bias is not None:
        bias = bias.to(torch.float32)
    if layout == "int8" and packed.shape[1] != out_f:
        # Padded columns get scale 0 (and bias 0): their outputs are 0.
        n_pad = packed.shape[1]
        scale = torch.nn.functional.pad(scale, (0, n_pad - out_f))
        if bias is not None:
            bias = torch.nn.functional.pad(bias, (0, n_pad - out_f))
        out_f = n_pad
    return PackedLinear(packed=packed, scale=scale, lut=lut, bias=bias,
                        in_features=in_f, out_features=out_f, nbits=nbits,
                        affine=affine_from_lut(lut), layout=layout)

"""256-bit descriptor helpers (torch port of orb_slam_cuda_tpu/ops/hamming.py).

Packed descriptors are (...,8) int32 holding the same bits as the
reference's uint32 words: word w, bit j = descriptor bit 32w+j. `>>` on
int32 is arithmetic, so every shift is followed by a mask.
"""

from __future__ import annotations

import torch

N_BITS = 256
N_WORDS = 8


def _shifts(device):
    return torch.arange(32, dtype=torch.int32, device=device)


def unpack_bits(desc):
    """(...,8) int32 packed -> (...,256) uint8 in {0,1}."""
    d = desc.to(torch.int32)
    bits = (d[..., :, None] >> _shifts(d.device)) & 1
    return bits.reshape(d.shape[:-1] + (N_BITS,)).to(torch.uint8)


def pack_bits(bits):
    """(...,256) {0,1}/bool -> (...,8) int32 (inverse of unpack_bits)."""
    b = bits.reshape(bits.shape[:-1] + (N_WORDS, 32)).to(torch.int64)
    words = torch.sum(b << _shifts(b.device).to(torch.int64), dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def bipolar(desc, dtype=torch.float32):
    """(...,8) int32 -> (...,256) bipolar {-1,+1}. float32 keeps the
    matmul in hamming_matrix exact on every device (TF32 is off)."""
    return unpack_bits(desc).to(dtype) * 2 - 1


def hamming_matrix(a_bip, b_bip):
    """(Q,256) x (D,256) bipolar -> (Q,D) int32 Hamming distances."""
    dot = a_bip @ b_bip.T
    return ((N_BITS - dot) * 0.5).to(torch.int32)


def popcount32(x):
    """Per-element popcount of int32 words (SWAR, masks after shifts)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF) + ((x >> 24) & 0xFF)


def hamming_matrix_packed(a, b):
    """(Q,8) x (D,8) packed -> (Q,D) int32 via XOR + popcount."""
    x = torch.bitwise_xor(a[:, None, :], b[None, :, :])
    return torch.sum(popcount32(x), dim=-1, dtype=torch.int32)


def hamming_pairwise(a, b):
    """(N,8) x (N,8) packed -> (N,) rowwise distances."""
    return torch.sum(popcount32(torch.bitwise_xor(a, b)), dim=-1, dtype=torch.int32)

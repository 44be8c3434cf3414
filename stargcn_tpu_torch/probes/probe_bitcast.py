"""Probe: which two bytes of a u8 block one u16 holds, on this card.

    python -m stargcn_tpu_torch.probes.probe_bitcast [--device cuda|cpu]

The port of ``scripts/probe_bitcast.py``.  On the TPU, ``pltpu.bitcast``
of a ``(32, 256)`` uint8 block gives ``(16, 256)`` uint16 with the low
byte from row ``2k`` and the high byte from row ``2k + 1`` (adjacent
sublanes); the 16-bit bitdense kernels read two packed rows per lane that
way, and ``pack_bits(row_interleave=bm)`` orders the rows for it.

This probe fills the reference's block, ``v[m, s] = (8m + s // 32) % 251``,
forms that row-pair view with ``row_pair_u16`` (the CUDA kernel
``ops/csrc/probe_bitcast.cu``, eight outputs a thread, for a tensor on the
card; ``plain_row_pair_u16`` for one on the CPU) and prints the reference's
decode lines for it.  Then it prints the same lines for a plain u16
reading of the same bytes (``v.view(torch.int16)``): on this card that
pairs two adjacent columns of one row, little-endian.  No row pairing
exists here, which is why the Hopper kernels of the ``pallas16`` route
honour the row order of its packs but never read them as u16.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from stargcn_tpu_torch.ops import _build
from stargcn_tpu_torch.utils.device import resolve_device

M, S = 32, 256
# Launches of the kernel wrapper on the card (the plain version is not
# counted).
LAUNCHES = {"probe_bitcast": 0}
_KERNEL = None                     # the C function, held after its load


def probe_input() -> np.ndarray:
    """The reference's ``(32, 256)`` uint8 block: ``(8m + s // 32) % 251``,
    distinct per (row, 32-column group)."""
    v = (np.arange(M)[:, None] * 8 + np.arange(S)[None, :] // 32) % 251
    return v.astype(np.uint8)


def _kernel():
    global _KERNEL
    if _KERNEL is None:
        _KERNEL = _build.load("probe_bitcast")
    return _KERNEL


def check_input(v: torch.Tensor):
    """``(M/2, S)`` for a ``v`` the kernel takes: a contiguous 2-D uint8
    matrix with an even number of rows on a CUDA device; raises
    otherwise."""
    if not v.is_cuda:
        raise ValueError(f"row_pair_u16: v must lie on the CPU or a CUDA "
                         f"device (got {v.device})")
    if v.dtype != torch.uint8 or v.dim() != 2 or v.shape[0] % 2:
        raise ValueError("row_pair_u16 takes a 2-D uint8 matrix with an "
                         f"even number of rows (got {v.dtype} "
                         f"{tuple(v.shape)})")
    if not v.is_contiguous():
        raise ValueError("row_pair_u16 takes a contiguous matrix")
    if v.numel() >= 2**31:
        raise ValueError("row_pair_u16: size exceeds int32")
    return v.shape[0] // 2, v.shape[1]


def row_pair_u16(v: torch.Tensor) -> torch.Tensor:
    """``out[k, s] = v[2k, s] | v[2k + 1, s] << 8``: the ``(M/2, S)``
    uint16 row-pair view of an ``(M, S)`` uint8 matrix, as the TPU's
    bitcast forms it.  A CUDA tensor goes to ``ops/csrc/probe_bitcast.cu``,
    a CPU tensor to ``plain_row_pair_u16``.

    The kernel takes microseconds, so the host path is kept short: the C
    function is held after its first load, the device is switched only
    where it is not the current one, and the stream is read as a raw
    handle."""
    if v.device.type == "cpu":
        return plain_row_pair_u16(v)
    half, cols = check_input(v)
    out = torch.empty((half, cols), dtype=torch.uint16, device=v.device)
    if out.numel() == 0:
        return out
    err = _build.call_on(v.device, _KERNEL or _kernel(), v.data_ptr(),
                         out.data_ptr(), half, cols,
                         _build.raw_stream(v.device))
    if err != 0:
        raise RuntimeError(f"row_pair_u16: kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["probe_bitcast"] += 1
    return out


def plain_row_pair_u16(v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``row_pair_u16``: shifts and ors in int32
    on any device, the bits handed back as uint16."""
    w = v[0::2].to(torch.int32) | (v[1::2].to(torch.int32) << 8)
    w = torch.where(w >= 32768, w - 65536, w)
    return w.to(torch.int16).view(torch.uint16)


def as_numpy_u16(t: torch.Tensor) -> np.ndarray:
    """A 16-bit tensor's bits as a numpy uint16 array."""
    return t.view(torch.int16).cpu().numpy().view(np.uint16)


def decode(out: np.ndarray, v: np.ndarray, log=print):
    """The reference's decode lines (``scripts/probe_bitcast.py:42-53``):
    the (low, high) bytes of four lanes, and where lane (0, 0)'s bytes
    occur in ``v``."""
    for i, j in ((0, 0), (0, 1), (1, 0), (3, 5)):
        lane = int(out[i, j])
        log(f"  out[{i},{j}] = lo {lane & 0xFF} hi {lane >> 8}")
    lo0, hi0 = int(out[0, 0]) & 0xFF, int(out[0, 0]) >> 8
    cand_lo = np.argwhere(v == lo0)[:4]
    cand_hi = np.argwhere(v == hi0)[:4]
    log(f"  lane(0,0) lo candidates {cand_lo.tolist()} hi candidates "
        f"{cand_hi.tolist()}")


def run(device="cuda", log=print):
    """Run the probe on ``device``; returns ``{'row_pair': (16, 256),
    'column_pair': (32, 128)}`` numpy uint16 arrays."""
    dev = resolve_device(device)
    v = probe_input()
    vt = torch.from_numpy(v).to(dev)
    rows = as_numpy_u16(row_pair_u16(vt))
    route = ("ops/csrc/probe_bitcast.cu" if dev.type == "cuda"
             else "the plain version on the CPU")
    log(f"row-pair view {rows.shape} u16, the TPU's pltpu.bitcast pairing "
        f"({route}): OK")
    decode(rows, v, log)
    cols = as_numpy_u16(vt.view(torch.int16))
    log(f"plain u16 reading of the same bytes on {dev.type} "
        f"(v.view(torch.int16)) {cols.shape}: adjacent columns of one row, "
        f"little-endian")
    decode(cols, v, log)
    return {"row_pair": rows, "column_pair": cols}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Probe the u8 -> u16 pairing (PyTorch/CUDA).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    run(parser.parse_args(argv).device, log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()

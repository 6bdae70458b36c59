"""The scatter-join dense compare pass: CUDA kernel wrapper + plain version.

Counterpart of genestrip_tpu/ops/pallas_lookup.py (`dense_pass_pallas`,
`dense_pass_xla`). For every bucket and scratch lane, the pass compares the
lane's query (h2, want) against the bucket's 4 stored slots and emits one
packed int32: (j << vb) | vidx for the first matching slot j, -1 for none.
The caller recovers found = (w >= 0), vidx = w & (2^vb - 1), j = w >> vb.

`dense_pass` is what the lookup calls. For tensors on the CPU it runs
`dense_pass_torch`; for tensors on a CUDA device it launches the kernel of
csrc/dense_pass.cu, or raises. There is no other switch.
"""

from __future__ import annotations

import ctypes

import torch

BUCKET = 4
MAX_VB = 29          # (3 << vb) | vidx must fit a non-negative int32


def _check(rows, sc_h, sc_w, vb: int) -> None:
    for name, t in (("rows", rows), ("sc_h", sc_h), ("sc_w", sc_w)):
        if t.dtype != torch.int32:
            raise TypeError(f"dense_pass: {name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"dense_pass: {name} must be 2-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"dense_pass: {name} must be contiguous")
        if t.device != rows.device:
            raise ValueError("dense_pass: all inputs must be on one device, "
                             f"got {rows.device} and {t.device}")
    if rows.shape[1] != 2 * BUCKET:
        raise ValueError(f"dense_pass: rows must be [NB, 8], got {tuple(rows.shape)}")
    if sc_h.shape != sc_w.shape or sc_h.shape[0] != rows.shape[0]:
        raise ValueError("dense_pass: sc_h/sc_w must both be [NB, R] with "
                         f"NB = {rows.shape[0]}, got {tuple(sc_h.shape)} "
                         f"and {tuple(sc_w.shape)}")
    if not 0 <= vb <= MAX_VB:
        raise ValueError(f"dense_pass: vb must be in [0, {MAX_VB}], got {vb}")


def dense_pass_torch(rows: torch.Tensor, sc_h: torch.Tensor,
                     sc_w: torch.Tensor, *, vb: int) -> torch.Tensor:
    """Plain PyTorch version, bit-identical to dense_pass_xla."""
    empty = (1 << vb) - 1
    res = torch.full(sc_h.shape, -1, dtype=torch.int32, device=sc_h.device)
    for j in range(BUCKET):
        kj = rows[:, j][:, None]
        pj = rows[:, BUCKET + j].to(torch.int64)[:, None] & 0xFFFFFFFF
        vj = pj & empty
        eq = (kj == sc_h) & ((pj >> vb) == sc_w) & (vj != empty)
        packed = ((j << vb) | vj).to(torch.int32)
        res = torch.where(eq & (res < 0), packed, res)
    return res


def dense_pass(rows: torch.Tensor, sc_h: torch.Tensor, sc_w: torch.Tensor,
               *, vb: int) -> torch.Tensor:
    """Dense pass over rows [NB, 8] and scratch planes sc_h/sc_w [NB, R]
    (all contiguous int32); returns packed [NB, R] int32."""
    _check(rows, sc_h, sc_w, vb)
    if rows.device.type == "cpu":
        return dense_pass_torch(rows, sc_h, sc_w, vb=vb)
    if rows.device.type != "cuda":
        raise ValueError(f"dense_pass: no kernel for device {rows.device}")
    if rows.data_ptr() % 16:
        raise ValueError("dense_pass: rows must be 16-byte aligned")
    lib = _lib()
    out = torch.empty(sc_h.shape, dtype=torch.int32, device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.gs_dense_pass(rows.data_ptr(), sc_h.data_ptr(),
                                sc_w.data_ptr(), out.data_ptr(),
                                rows.shape[0], sc_h.shape[1], vb, stream)
    if err != 0:
        raise RuntimeError(f"dense_pass kernel launch failed: CUDA error {err}")
    dense_pass.launches += 1
    return out


dense_pass.launches = 0      # kernel launches; the CPU path does not count


def _lib() -> ctypes.CDLL:
    from genestrip_tpu_torch.ops import _build
    lib = _build.load("dense_pass")
    lib.gs_dense_pass.restype = ctypes.c_int
    lib.gs_dense_pass.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib

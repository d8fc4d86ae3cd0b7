"""P1: dynamic-bound loop plus dynamic row-offset writes (port of
scripts/probe_dynlane.py:29-62; kernel `dynlane_kernel` in
csrc/probes.cu).

One block reads (tlo, thi) from a device table and, for tc in
[tlo, thi], writes rows [tc*SP, (tc+1)*SP) of out [1, T*SP, W] as
x [SP, W] + vcol[0, tc*SP + row, 0]; other rows are left as they are.
`dynlane` launches the kernel for CUDA tensors and runs `dynlane_ref` for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import build

SP, T, W = 144, 8, 384
TABS = ((2, 6),)

_SIG = {"dynlane_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
        + [ctypes.c_void_p]}


def inputs(seed: int = 0, device="cpu"):
    """The probe's inputs (the JAX probe's shapes, values from `seed`):
    tabs [1, 2] int32, vcol [1, T*SP, 2] int32 below 2^20, x [SP, W] f32."""
    rng = np.random.RandomState(seed)
    tabs = torch.tensor(TABS, dtype=torch.int32)
    vcol = torch.from_numpy(rng.randint(0, 1 << 20, (1, T * SP, 2)).astype(
        np.int32))
    x = torch.from_numpy(rng.rand(SP, W).astype(np.float32))
    return tabs.to(device), vcol.to(device), x.to(device)


def dynlane_ref(tabs, vcol, x, out):
    """Plain version: a host loop over the table's range. Writes `out`
    [1, T*SP, W] in place and returns it."""
    tlo, thi = (int(a) for a in tabs.reshape(-1)[:2].tolist())
    for tc in range(tlo, thi + 1):
        rows = slice(tc * SP, (tc + 1) * SP)
        out[0, rows] = x + vcol[0, rows, 0:1].float()
    return out


def dynlane_cuda(tabs, vcol, x, out):
    """Launch P1 (same contract as `dynlane_ref`)."""
    for t, dt in ((tabs, torch.int32), (vcol, torch.int32),
                  (x, torch.float32), (out, torch.float32)):
        if not t.is_cuda or not t.is_contiguous() or t.dtype != dt:
            raise ValueError("dynlane: contiguous CUDA tensors of the "
                             "probe's dtypes")
    if x.shape != (SP, W) or out.shape != (1, T * SP, W) \
            or vcol.shape != (1, T * SP, 2):
        raise ValueError("dynlane: shapes")
    lib = build.load("probes", _SIG)
    err = lib.dynlane_launch(tabs.data_ptr(), vcol.data_ptr(), x.data_ptr(),
                             out.data_ptr(), SP, W,
                             torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dynlane_launch")
    dynlane.launches += 1
    return out


def dynlane(tabs, vcol, x, out):
    if x.is_cuda:
        return dynlane_cuda(tabs, vcol, x, out)
    return dynlane_ref(tabs, vcol, x, out)


dynlane.launches = 0

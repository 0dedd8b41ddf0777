"""Where the panel kernel's time goes, phase by phase, on the card.

    python3 -m pnmol_tpu_torch.ops.panel_lq_phases

Builds ``csrc/panel_lq.cu`` with ``-DPANEL_LQ_PHASES``, in which the last
column CTA sums the SM clock (``clock64``) spent in each phase of the
reflector loop (the grid barrier, the sums of the partials, the reflector's
scalars, the pass over rows k and k + 1, the pass over the other rows) and
writes the sums behind its scratch. Runs it at the solvers' panel shapes,
and on the tall layout (the leaf QR) at the R-form sweeps' first leaves,
with the launch rule's CTA count, and prints each phase's share and its
time per reflector, scaled to the instrumented kernel's own time (CUDA
events). The first reflector's barrier phase also holds the chunk's load.
The stamps cost time themselves (each syncs the CTA), so the instrumented
kernel is a little slower than the real one. Needs a GPU; imports neither
JAX nor the JAX package.
"""

import ctypes
import subprocess

import numpy as np
import torch

from pnmol_tpu_torch.ops import cuda_build
from pnmol_tpu_torch.ops import qr_householder as tq

PHASES = ("barrier", "sums of the partials", "scalars", "rows k and k+1",
          "other rows and next partials")


def phase_cycles(x, launch, tall=False):
    """Clock cycles of each phase in the last column CTA, one launch of the
    panel LQ of ``x`` at off 0, or with ``tall`` of the leaf QR of ``x``."""
    lib = ctypes.CDLL(str(cuda_build.build("panel_lq", defines=("PANEL_LQ_PHASES",))))
    fn = lib.leaf_qr_f64 if tall else lib.panel_lq_f64
    fn.argtypes = [*(tq._LEAF_QR_ARGS if tall else tq._PANEL_LQ_ARGS), ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows, cols = x.shape
    reflectors = cols if tall else rows
    out = torch.empty_like(x)
    factor = torch.empty((reflectors, reflectors), dtype=x.dtype, device=x.device)
    scratch = torch.zeros(((2 * launch.ctas + 3 + reflectors) * reflectors + len(PHASES),),
                          dtype=x.dtype, device=x.device)
    count = torch.empty((1,), dtype=torch.int32, device=x.device)
    sizes = (rows, cols) if tall else (rows, cols, 0)

    def run():
        err = fn(x.data_ptr(), out.data_ptr(), factor.data_ptr(), scratch.data_ptr(),
                 count.data_ptr(), *sizes, launch.ctas, launch.width,
                 int(launch.registers), x.device.index,
                 torch.cuda.current_stream(x.device).cuda_stream)
        if err:
            raise RuntimeError(f"instrumented {'leaf_qr' if tall else 'panel_lq'}: "
                               f"cudaError {err}")

    run()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):
        run()
    stop.record()
    torch.cuda.synchronize()
    return scratch[-len(PHASES):].cpu().numpy(), start.elapsed_time(stop) / 10


def main():
    if not torch.cuda.is_available():
        raise SystemExit("panel_lq_phases: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    for kind, rows, cols in (("panel", 128, 3586), ("panel", 128, 6658), ("panel", 128, 1538),
                             ("leaf", 3586, 32), ("leaf", 6658, 32)):
        tall = kind == "leaf"
        x = torch.tensor(rng.standard_normal((rows, cols)), device=dev)
        launch = (tq.leaf_qr_launch if tall else tq.panel_lq_launch)(rows, cols, 8, num_sms)
        cycles, ms = phase_cycles(x, launch, tall)
        share = cycles / cycles.sum()
        reflectors = cols if tall else rows
        parts = ", ".join(f"{name} {s:.1%} ({s * ms * 1e3 / reflectors:.2f} us)"
                          for name, s in zip(PHASES, share))
        print(f"{kind} {rows} x {cols} f64, {launch.ctas} CTAs: instrumented kernel "
              f"{ms:.4f} ms; per reflector: {parts} [{card}]", flush=True)


if __name__ == "__main__":
    main()

"""Where each of the port's CUDA kernels spends its time, phase by phase.

    python3 tools/kernel_phases.py      # from the repository root; needs one CUDA card

For each kernel it builds a copy of ``csrc/<kernel>.cu`` in which every
``// PHASE: <name>`` marker line becomes a ``clock64`` stamp (thread 0 of
every CTA records the SM clock as it passes the marker), runs the copy once
through the kernel's own wrapper at the serving shape, after a warm-up, and
prints the cycles of each phase (mean and max over the CTAs) beside the
production kernel's time by CUDA-graph replay and the instrumented copy's.
A phase is named by the marker that ends it; the first marker marks the
start.  The instrumented copies go to ``build/kernels/``; nothing of them is
used outside this script.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from multimodal_av_model_tpu_torch.ops import cuda_build  # noqa: E402

MARKER = re.compile(r"^[ \t]*// PHASE: (.+)$", re.MULTILINE)
_MAX_CTAS = 4096
_MAX_STAMPS = 16
_STAMPS = r"""
__device__ unsigned long long kp_clock[%d][%d];
__device__ __forceinline__ void kp_stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long c;
    asm volatile("mov.u64 %%0, %%%%clock64;" : "=l"(c));
    kp_clock[blockIdx.x + blockIdx.y * gridDim.x][k] = c;
  }
}
extern "C" int kp_read(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, kp_clock, (size_t)n * %d * sizeof(unsigned long long));
}
""" % (_MAX_CTAS, _MAX_STAMPS, _MAX_STAMPS)


def _source(kernel: str) -> str:
    with open(os.path.join(cuda_build.CSRC_DIR, cuda_build.SOURCES[kernel])) as f:
        return f.read()


def phases(kernel: str) -> list[str]:
    """The names of the kernel's ``// PHASE:`` markers, in source order."""
    return MARKER.findall(_source(kernel))


def instrument(kernel: str) -> str:
    """The kernel's source with marker ``k`` replaced by ``kp_stamp(k);``."""
    names = phases(kernel)
    if not 2 <= len(names) <= _MAX_STAMPS or len(set(names)) != len(names):
        raise ValueError(f"{kernel}: need 2 to {_MAX_STAMPS} distinct PHASE markers, "
                         f"found {names}")
    counter = iter(range(len(names)))
    src = MARKER.sub(lambda m: m.group(0).split("//")[0] + f"kp_stamp({next(counter)});",
                     _source(kernel))
    return src.replace("namespace {", _STAMPS + "\nnamespace {", 1)


def _build(kernel: str) -> ctypes.CDLL:
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(cuda_build.BUILD_DIR, f"phases_{kernel}.cu")
    lib = os.path.join(cuda_build.BUILD_DIR, f"libphases_{kernel}.so")
    with open(src, "w") as f:
        f.write(instrument(kernel))
    log = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
                         check=True, capture_output=True, text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line or "Performance Loss" in line:
            print(f"[{kernel}] ptxas: {line.strip()[:160]}")
    return ctypes.CDLL(os.path.abspath(lib))


def _graph_ms(torch, fn, iters: int = 100) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def measure(torch, kernel: str, call, ctas: int) -> None:
    """Time ``call`` (a launch through the kernel's wrapper) with the
    production build, then with the instrumented one in its place in
    ``cuda_build``'s cache of loaded libraries, and print the phases of the
    instrumented launch."""
    ms = _graph_ms(torch, call)                 # also loads the production library
    lib, production = _build(kernel), cuda_build._libs[kernel]
    cuda_build._libs[kernel] = lib
    cuda_build.rebind(kernel)
    try:
        inst_ms = _graph_ms(torch, call)
        call()
        torch.cuda.synchronize()
    finally:
        cuda_build._libs[kernel] = production
        cuda_build.rebind(kernel)
    clock = np.zeros((_MAX_CTAS, _MAX_STAMPS), np.uint64)
    lib.kp_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.kp_read(clock.ctypes.data, _MAX_CTAS) != 0:
        raise RuntimeError("reading the stamps failed")
    names = phases(kernel)
    cycles = np.diff(clock[:ctas, :len(names)].astype(np.int64), axis=1)
    print(f"[{kernel}] {ctas} CTAs; {ms * 1e3:.2f} us by graph replay "
          f"({inst_ms * 1e3:.2f} us instrumented); cycles per phase, mean / max over CTAs:")
    for name, c in zip(names[1:], cycles.T):
        print(f"[{kernel}]   {name:44s} {c.mean():9.0f} {c.max():9.0f}")
    total = cycles.sum(axis=1)
    print(f"[{kernel}]   {'total':44s} {total.mean():9.0f} {total.max():9.0f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    from multimodal_av_model_tpu_torch.ops import logmel, lstm_scan, resize

    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.3 * rng.standard_normal((4, 128 * 534))).astype(np.float32)).cuda()
    measure(torch, "logmel", lambda: logmel.log_mel_spectrogram_cuda(x),
            logmel.logmel_plan(*x.shape)["ctas"])
    frames = torch.from_numpy(rng.integers(0, 256, size=(512, 128, 128, 3),
                                           dtype=np.uint8)).cuda()
    plan = resize.lip_band_plan(128, 128, 3, 96, 96, 1)
    measure(torch, "lip", lambda: resize.lip_preprocess_cuda(frames, 96),
            plan["n_bands"] * frames.shape[0])
    z, w, b, dy = (torch.randn(shape, generator=torch.Generator().manual_seed(k)).cuda()
                   .bfloat16() for k, shape in enumerate([(8, 128, 2, 2048), (2, 2048, 512),
                                                          (2, 2048), (8, 128, 2, 512)]))
    w, lens = w / 512 ** 0.5, torch.from_numpy(rng.integers(64, 129, 8)).cuda()

    def lstm():                                 # a request's rows: forward, then backward
        _, saved = lstm_scan.lstm_scan_op(z, lens, w, b, True)
        lstm_scan.lstm_scan_backward_op(dy, lens, w, saved)

    measure(torch, "bilstm", lstm, 2 * lstm_scan.lstm_scan_plan("forward", 8, 512, 2)["cs"])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

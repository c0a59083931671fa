"""K2's and K4's times on the card, and the host's cost of their launch
path, item by item.

    PYTHONPATH=. python tools/kernel_times.py

Prints the card's name and power limit, then JSON lines:

* ``host``: microseconds of host time per call (``perf_counter_ns``
  over 10^4 calls, no synchronisation, at a small shape so that the
  card keeps up) of each item a launch path may spend time on, of the
  whole K2 and K4 wrappers, and of ``torch.randn``;
* ``k2``: K2 at 17408 x 128 f32 beside ``torch.randn`` of the same
  shape, like for like and in turns: per call (CUDA events over a loop
  of 500 calls) and device time (the profiler's kernel time), the
  allocating forms, and the ``out=`` forms where the package has them
  (K2 scaled by sigma, as the DMC step draws);
* ``k4``: K4 at the density shape (17408 x 128, 128 bins) and the g2
  rows (17408 x 128 rows of 128 distances), per call and device time.

It times whichever ``phd_qmclib_torch`` ``PYTHONPATH`` names, so the
same script times an older checkout (``PYTHONPATH=<checkout>``); like
``tools/profile_steps.py`` it takes its timing helpers and shapes from
the ``chip_smoke.py`` of that checkout.  Needs a CUDA device.
"""
import ctypes
import inspect
import json
import math
import subprocess
import time

import numpy as np
import torch

import chip_smoke as cs
from phd_qmclib_torch.ops import _build, histogram, prng

HOST_CALLS = 10_000
SMALL = (64, 128)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds per call of ``fn()``, after a warm-up."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def dummy_args(fn) -> list:
    """Arguments of a launch function that make it return at once
    (zero elements), of its own signature: pointers 0, ints 0, a 64-bit
    key or step 1, a double 1.0."""
    args = []
    for argtype in fn.argtypes:
        if argtype is ctypes.c_double:
            args.append(1.0)
        elif argtype is ctypes.c_uint64:
            args.append(1)
        else:
            args.append(0)
    return args


def main() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    scaled = "scale" in inspect.signature(prng.normal).parameters
    sigma = math.sqrt(2 * cs.TIME_STEP)
    small = torch.empty(SMALL, device=device)
    unit = torch.tensor(1.0, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    lib = _build.library()
    normals = lib.qmc_philox_normals_f32
    normals_args = dummy_args(normals)

    def with_guard():
        with torch.cuda.device(device):
            pass

    items = {
        "torch.device('cuda', 0)": lambda: torch.device("cuda", 0),
        "torch.empty (64, 128) f32": lambda: torch.empty(SMALL,
                                                         device=device),
        "with torch.cuda.device(d)": with_guard,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "torch._C._cuda_getDevice()": lambda: torch._C._cuda_getDevice(),
        "tensor.data_ptr()": lambda: small.data_ptr(),
        "_build.library()": _build.library,
        "lib.qmc_philox_normals_f32 lookup":
            lambda: lib.qmc_philox_normals_f32,
        "ctypes call of K2's launch function, returning at once":
            lambda: normals(*normals_args),
    }
    if hasattr(prng, "launch_args"):
        items["prng.launch_args(key, step)"] = lambda: prng.launch_args(
            1, 12345)
    if hasattr(prng, "check_key"):
        items["prng.check_key(key, step)"] = lambda: prng.check_key(1, 12345)
    items["prng.normal (64, 128)"] = lambda: prng.normal(
        1, 7, SMALL, torch.float32, device)
    if scaled:
        noise = torch.empty(SMALL, device=device)
        items["prng.normal (64, 128), scale, out="] = lambda: prng.normal(
            1, 7, SMALL, torch.float32, device, scale=sigma, out=noise)
    else:
        items["sigma * prng.normal (64, 128)"] = lambda: sigma * prng.normal(
            1, 7, SMALL, torch.float32, device)
    buf = torch.empty(SMALL, device=device)
    items["torch.randn (64, 128), generator"] = lambda: torch.randn(
        SMALL, device=device, generator=gen)
    items["torch.randn (64, 128), generator, out="] = lambda: torch.randn(
        SMALL, generator=gen, out=buf)
    items["histogram.walker_histogram (64, 128), 128 bins"] = \
        lambda: histogram.walker_histogram(small, unit, 128)
    print(json.dumps({"host": {name: host_us(fn)
                               for name, fn in items.items()},
                      "calls": HOST_CALLS, "scaled_out_form": scaled}),
          flush=True)

    shape = (cs.MAX_WALKERS, cs.NOP)
    big_noise, big_buf = (torch.empty(shape, device=device)
                          for _ in range(2))
    forms = {"allocating": (
        lambda: prng.normal(1, 7, shape, torch.float32, device),
        lambda: torch.randn(shape, device=device, generator=gen))}
    if scaled:
        forms["out"] = (
            lambda: prng.normal(1, 7, shape, torch.float32, device,
                                scale=sigma, out=big_noise),
            lambda: torch.randn(shape, generator=gen, out=big_buf))
    else:
        forms["sigma *"] = (
            lambda: sigma * prng.normal(1, 7, shape, torch.float32, device),
            lambda: torch.randn(shape, generator=gen, out=big_buf))
    for form, (kernel, library) in forms.items():
        k1 = cs.cuda_ms(kernel, 500)
        l1 = cs.cuda_ms(library, 500)
        l2 = cs.cuda_ms(library, 500)
        k2 = cs.cuda_ms(kernel, 500)
        print(json.dumps({"k2": form, "shape": list(shape),
                          "kernel_ms": [k1, k2], "library_ms": [l1, l2],
                          "kernel_device_ms": cs.device_ms(kernel, 200),
                          "library_device_ms": cs.device_ms(library, 200)}),
              flush=True)

    density = torch.as_tensor(np.random.default_rng(6).uniform(
        0, cs.NOP, shape), dtype=torch.float32, device=device)
    distances = cs.pair_distances(device)
    half = torch.tensor(0.5, device=device)
    for label, pos, bin_size, reps in (("density", density, unit, 200),
                                       ("g2 rows", distances, half, 20)):
        fn = (lambda p=pos, b=bin_size:
              histogram.walker_histogram(p, b, cs.NOP))
        ms = [cs.cuda_ms(fn, reps) for _ in range(2)]
        print(json.dumps({"k4": label, "shape": list(pos.shape),
                          "num_bins": cs.NOP, "ms": ms,
                          "device_ms": cs.device_ms(fn, reps)}), flush=True)


if __name__ == "__main__":
    main()

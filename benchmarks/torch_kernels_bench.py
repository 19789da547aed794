"""Kernel micro-benchmarks on the port (port of
``benchmarks/kernels_bench.py``): the reference's seven rows at its
shapes, each through ``repro_torch.kernels.ops``.

On the card (``--device cuda``, the default) each row runs the
hand-written kernel and its plain PyTorch version on the same inputs,
holds the kernel to the plain version (B1-B3 bit for bit, B4 and B5
within ``chip_smoke.KERNEL_ATOL``/``KERNEL_RTOL``; a mismatch raises),
and times both with ``chip_smoke.time_cold_ms`` (CUDA events, the L2
flushed before each run). On ``--device cpu`` it times the plain
versions only, on the host's clock (``chip_smoke.host_ms``): a CPU time
is no kernel number. Rows are named after the reference's, with
``_kernel`` and ``_plain`` in place of ``_ref``; each is (name,
microseconds a call).

    PYTHONPATH=src:. python benchmarks/torch_kernels_bench.py [--device cpu]
"""
from __future__ import annotations

import argparse

# (reference row stem, shape tag)
ROWS = (("flash_attention", "256"), ("ssd", "256"),
        ("grad_agg", "8x1024x512"),
        ("quantize_int8", "8x1024x512"), ("dequant_agg_int8", "8x1024x512"),
        ("quantize_int4", "8x1024x512"), ("dequant_agg_int4", "8x1024x512"))


def cases(device):
    """{stem: (kernel fn, plain fn, exact)} on inputs drawn on ``device``
    at the reference's shapes: flash (1, 256, 4/2 heads, 64); SSD (1,
    256, 4, 64), chunk 64, B/C (1, 256, 1, 64); grad_agg, quantize and
    dequant_agg at (8, 1024, 512), int8 and int4."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.grad_agg import grad_agg_ref
    from repro_torch.kernels.quantize import dequant_agg_ref, quantize_ref
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    q, k, v = randn(1, 256, 4, 64), randn(1, 256, 2, 64), randn(1, 256, 2, 64)

    def flash_plain(q, k, v):
        out = flash_attention_ref(*(t.transpose(1, 2).contiguous()
                                    for t in (q, k, v)))
        return out.transpose(1, 2)

    x = randn(1, 256, 4, 64)
    dt = F.softplus(randn(1, 256, 4)) * 0.1
    A = -torch.exp(randn(4) * 0.5)
    B, C = randn(1, 256, 1, 64) * 0.3, randn(1, 256, 1, 64) * 0.3
    g = randn(8, 1024, 512)
    rho = torch.full((8,), 0.125, device=device)
    out = {
        "flash_attention": (lambda: ops.flash_attention(q, k, v),
                            lambda: flash_plain(q, k, v), False),
        "ssd": (lambda: ops.ssd(x, dt, A, B, C, chunk=64)[0],
                lambda: ssd_chunked(x, dt, A, B, C, chunk=64)[0], False),
        "grad_agg": (lambda: ops.grad_agg(g, rho),
                     lambda: grad_agg_ref(g, rho), True),
    }
    for bits in (8, 4):
        qz, sc = quantize_ref(g, seed=0, bits=bits)
        out[f"quantize_int{bits}"] = (
            lambda b=bits: ops.quantize(g, seed=0, bits=b),
            lambda b=bits: quantize_ref(g, seed=0, bits=b), True)
        out[f"dequant_agg_int{bits}"] = (
            lambda b=bits, qz=qz, sc=sc: ops.dequant_agg(qz, sc, rho, bits=b),
            lambda b=bits, qz=qz, sc=sc: dequant_agg_ref(qz, sc, rho, bits=b),
            True)
    return out


def _hold(torch, stem, got, want, exact, atol, rtol):
    """The kernel's output against the plain version's; the max abs
    error."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for a, b in zip(got, want):
        if exact:
            if not torch.equal(a, b):
                raise AssertionError(f"{stem}: the kernel differs from its "
                                     "plain version (bit for bit expected)")
        elif not torch.allclose(a, b, atol=atol, rtol=rtol):
            raise AssertionError(
                f"{stem}: the kernel differs from its plain version by "
                f"{float((a - b).abs().max()):.3e} (atol {atol}, rtol "
                f"{rtol})")
        if a.is_floating_point():
            err = max(err, float((a - b).abs().max()))
    return err


def run(device="cuda"):
    """[(row name, us a call)]: on the card each stem's ``_kernel`` row
    (held to the plain version first) then its ``_plain`` row; on the CPU
    the ``_plain`` rows only."""
    import torch

    import chip_smoke as cs
    from repro_torch import obs, require_device

    dev = require_device(device)
    cuda = dev.type == "cuda"
    fns = cases(dev)
    flush = (torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
             if cuda else None)
    rows = []
    for stem, shape in ROWS:
        kernel, plain, exact = fns[stem]
        if cuda:
            got = kernel()
            torch.cuda.synchronize()
            err = _hold(torch, stem, got, plain(), exact, cs.KERNEL_ATOL,
                        cs.KERNEL_RTOL)
            obs.log(f"  {stem}: kernel held to its plain version "
                    f"({'bit for bit' if exact else 'max abs err'} "
                    f"{err:.3e})")
            rows.append((f"{stem}_kernel_{shape}",
                         1e3 * cs.time_cold_ms(torch, kernel, flush)))
            rows.append((f"{stem}_plain_{shape}",
                         1e3 * cs.time_cold_ms(torch, plain, flush,
                                               iters=10)))
        else:
            rows.append((f"{stem}_plain_{shape}",
                         1e3 * cs.host_ms(torch, plain, reps=1,
                                          device="cpu")))
    return rows


def main(argv=None):
    from benchmarks.torch_common import device_arg, device_name
    from repro_torch import obs

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    device_arg(ap)
    args = ap.parse_args(argv)
    rows = run(args.device)
    obs.log(f"# kernels [{device_name(args.device)}]")
    for name, us in rows:
        obs.log(f"  {name}: {us:.0f} us/call")
    return rows


if __name__ == "__main__":
    main()

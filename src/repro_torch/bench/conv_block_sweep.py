"""Row blocks and sample groups of ``conv_threshold`` (K2) on the card.

    python -m repro_torch.bench.conv_block_sweep     # PYTHONPATH=src

A K2 block stages its channels' whole banks, its weights and its input
band once, so the rows a block covers (``block_h``) and, for images that
one block covers whole, the samples it takes (``samples_per_block``) trade
per-block staging against the grid's parallelism. This sweep times K2 on
1024 samples of seeded codes at the IC and CNV golden stage shapes and at
full-width CNV conv1, for each row block of ``deploy.autotune``'s
candidates and sample groups of 1 to 16, through the kernel's C entry
point (device time, ``common.time_ms``; each configuration held equal to
the plain version first), beside the default that ``kernels.ops`` picks
(``conv_block_rows``, ``conv_threshold_plan``). It prints one row per
stage and exits non-zero without a card.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.bench.common import banner, print_rows, row, time_ms
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.conv_threshold import pad_input

#: (label, H, W, C, F, kernel, stride, padding, S): the IC and CNV golden
#: stages (tests/golden) and CNV's conv1 at full width
STAGES = [("ic_conv0", 16, 16, 3, 32, 1, 1, "SAME", 255),
          ("ic_conv1", 16, 16, 32, 4, 4, 1, "SAME", 255),
          ("ic_conv4", 4, 4, 32, 4, 4, 1, "SAME", 255),
          ("cnv_conv0", 32, 32, 3, 8, 3, 1, "VALID", 1),
          ("cnv_conv5", 3, 3, 32, 32, 3, 1, "VALID", 1),
          ("cnv_conv1_full", 30, 30, 64, 64, 3, 1, "VALID", 1)]
SAMPLES = 1024
GROUPS = (1, 2, 4, 8, 16)


def sweep(device="cuda", samples: int = SAMPLES, seed: int = 0):
    """One row per stage: the device µs of every (block_h, samples per
    block) that fits, and the default's."""
    from repro_torch.deploy.autotune import block_h_candidates

    fn = _build.entry_point("conv_threshold")
    g = torch.Generator().manual_seed(seed)
    rows = []
    for label, h, w, c, f, k, st, pad, s in STAGES:
        x = torch.randint(0, 256 if s > 1 else 2, (samples, h, w, c),
                          generator=g, dtype=torch.int32).to(device)
        w2d = torch.randint(-127, 128, (k * k * c, f), generator=g,
                            dtype=torch.int8).to(device)
        t = torch.sort(torch.randint(-20000, 20000, (f, s), generator=g,
                                     dtype=torch.int32), dim=1).values
        t = t.to(device)
        oh = -(-h // st) if pad == "SAME" else (h - k) // st + 1
        ow = -(-w // st) if pad == "SAME" else (w - k) // st + 1
        kw = dict(kernel=k, stride=st, padding=pad, out_h=oh, out_w=ow)
        xp = pad_input(x, **kw).contiguous()
        nb, hp, wp, _ = xp.shape
        want = ref.conv_threshold_ref(xp, w2d, t, kernel=k, stride=st,
                                      out_h=oh, out_w=ow)
        out = torch.empty_like(want)
        bh0 = ops.conv_block_rows(oh, ow, c, k)
        plan0 = ops.conv_threshold_plan(c, f, k, st, wp, oh, ow, bh0, s,
                                        samples=nb)
        default = (plan0["block_h"], plan0["samples_per_block"])
        times = {}
        configs = [(bh, grp) for bh in block_h_candidates(oh)
                   for grp in (GROUPS if bh == oh else (1,))]
        for bh, grp in sorted(set(configs) | {default}):
            plan = ops.conv_threshold_plan(c, f, k, st, wp, oh, ow, bh, s,
                                           samples=nb)
            if plan["block_h"] != bh:
                continue

            def call(bh=bh, grp=grp, plan=plan):
                return fn(xp.data_ptr(), w2d.data_ptr(), t.data_ptr(),
                          out.data_ptr(), nb, hp, wp, c, f, k, st, oh, ow,
                          bh, s, plan["block_n"], plan["pixel_stride"],
                          plan["k_chunk"], grp, int(plan["search"]),
                          torch.cuda.current_stream().cuda_stream)
            if call() != 0:
                continue                # the group's bands do not fit
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{label} block_h {bh} group {grp}: "
                                   f"kernel != plain version")
            times[f"{bh}/{grp}"] = time_ms(call) * 1e3
        default = f"{default[0]}/{default[1]}"
        best = min(times, key=times.get)
        rows.append(row(f"conv_block_sweep/{label}", times[default],
                        default=default, fastest=best,
                        fastest_us=f"{times[best]:.3f}",
                        candidates_us=";".join(f"{key}:{v:.3f}"
                                    for key, v in times.items())))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("conv_block_sweep: no CUDA device; it times the kernel on the "
              "card", file=sys.stderr)
        return 2
    banner("K2 row blocks and sample groups (block_h/samples: us)")
    print_rows(sweep())
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

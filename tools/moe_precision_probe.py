"""Where the bf16 error of the MoE ``ffn`` mode comes from, on one card.

Runs granite-moe-3b-a800m's expert products at one 4 x 2048 prefill
wave's bin shapes (40 experts, capacity 2048, d_model 1536, d_ff 512;
random inputs from a seed) the ways the MoE modes cut them over a model
axis of 4, on one process:

* ``whole``: every expert, every slot, the whole d_ff (the einsum path);
* ``ep``: 10 experts a block; ``cap``: 512 slots a block;
* ``ffn``: d_ff in blocks of 128, the four partial outputs summed in bf16
  (the reduction in the compute dtype) and in float32.

Each output's max |error| over the max |reference| is printed against a
float64 evaluation of the same bf16 inputs, once with cuBLAS allowed to
reduce split-K partials in bf16 (PyTorch's default) and once not; with
the number of gate-product entries of the narrow (N = 128) products that
differ from the matching columns of the whole product, and the cuBLAS
kernels each product shape launches.

    python3 tools/moe_precision_probe.py
"""
import json
import subprocess

import torch
import torch.nn.functional as F

E, CAP, D, FF, P = 40, 2048, 1536, 512, 4


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("moe_precision_probe: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(20_260_417)
    bf = torch.bfloat16
    x = torch.randn((E, CAP, D), generator=gen, device=dev).to(bf)
    wg = (torch.randn((E, D, FF), generator=gen, device=dev)
          * D ** -0.5).to(bf)
    wu = (torch.randn((E, D, FF), generator=gen, device=dev)
          * D ** -0.5).to(bf)
    wd = (torch.randn((E, FF, D), generator=gen, device=dev)
          * FF ** -0.5).to(bf)

    def ffn(x, wg, wu, wd):
        return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

    d64 = [t.double() for t in (x, wg, wu, wd)]
    ref = ffn(*d64)
    scale = float(ref.abs().max())

    def err(y):
        return float((y.double() - ref).abs().max()) / scale

    fb = FF // P
    out = {"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), "torch": torch.__version__}
    flag = torch.backends.cuda.matmul
    for allow in (True, False):
        flag.allow_bf16_reduced_precision_reduction = allow
        whole = ffn(x, wg, wu, wd)
        g = torch.bmm(x, wg)
        ep = torch.cat([ffn(x[i:i + E // P], wg[i:i + E // P],
                            wu[i:i + E // P], wd[i:i + E // P])
                        for i in range(0, E, E // P)])
        cl = CAP // P
        cap = torch.cat([ffn(x[:, i:i + cl], wg, wu, wd)
                         for i in range(0, CAP, cl)], dim=1)
        parts, g_diff = [], 0
        for r in range(P):
            blk = slice(r * fb, (r + 1) * fb)
            g_r = torch.bmm(x, wg[..., blk].contiguous())
            g_diff += int((g_r != g[..., blk]).sum())
            parts.append(ffn(x, wg[..., blk].contiguous(),
                             wu[..., blk].contiguous(),
                             wd[:, blk].contiguous()))
        bf_sum = parts[0].clone()
        for p in parts[1:]:
            bf_sum += p
        f32_sum = sum(p.float() for p in parts).to(bf)
        kernels = {}
        for name, shape_n in (("N=512", FF), ("N=128", fb)):
            w = wg[..., :shape_n].contiguous()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                torch.bmm(x, w)
                torch.cuda.synchronize()
            kernels[name] = sorted({e.key[:60] for e in prof.key_averages()
                                    if e.device_type.name == "CUDA"})
        out[f"reduced_precision_reduction={allow}"] = {
            "whole": err(whole), "ep": err(ep), "cap": err(cap),
            "ffn bf16 sum": err(bf_sum), "ffn float32 sum": err(f32_sum),
            "narrow gate entries != whole's": g_diff,
            "gate entries": g.numel(), "kernels": kernels}
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()

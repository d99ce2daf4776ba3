"""How far rounding p and dS to 16 bits moves K1's bfloat16 / float16
results, without a card.

K1's 16-bit kernels feed p (forward: P . V; backward: P^T . dO) and dS
(dS . K, dS^T . q) to 16-bit tensor-core products. This script repeats
those products in float32 on the CPU with p and dS rounded to the dtype
once (``single``) or split into hi + lo in the dtype (``split``, what
the kernels do), against the plain float32 products, on seeded
``[B, 8, 512, 64]`` inputs (default B = 16: the training shape) with
the training CLI's packed segments (``--no-segments``: causal only).
It prints, per output (O, dq, dk, dv), the largest float32 error before
the output is rounded to the dtype, in ulps of 1.0 (relative to
max(1, |plain|)), and the largest error after rounding over the kernel
contract's tolerance (1e-2 for bfloat16, 2e-3 for float16, relative to
max(1, |plain|)): above 1.0 the contract fails.

    python scripts/flash16_rounding.py --dtype bfloat16 --mode single --seed 5
"""
import argparse
import contextlib
import io
import json
import math

import torch

from bigdl_tpu_torch.models.transformer_train import synthetic_corpus

TOL = {"bfloat16": 1e-2, "float16": 2e-3}
ULP_AT_1 = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def rounding_errors(dtype: str, mode: str, seed: int = 0, batch: int = 16,
                    segments: bool = True, heads: int = 8,
                    s_len: int = 512, head_dim: int = 64) -> dict:
    """``{"float_error_ulps": {...}, "error_over_tolerance": {...}}`` for
    O, dq, dk and dv (see the module's text)."""
    dt = getattr(torch, dtype)
    torch.manual_seed(seed)
    # the packed documents of 30,000 synthetic tokens at the training
    # shape, as many rows as it takes elsewhere
    with contextlib.redirect_stdout(io.StringIO()):
        corpus = synthetic_corpus(30000 * batch * s_len // (16 * 512), 32000,
                                  s_len, "packed", batch)
    seg = torch.from_numpy(corpus[0][1][:batch]).long()
    scale = 1 / math.sqrt(head_dim)

    def operand(x):
        hi = x.to(dt).float()
        return hi + (x - hi).to(dt).float() if mode == "split" else hi

    ulps, over_tol = {}, {}
    for b in range(batch):
        q, k, v, do = (torch.randn(heads, s_len, head_dim).to(dt).float()
                       for _ in range(4))
        keep = torch.ones(s_len, s_len, dtype=torch.bool).tril()
        if segments:
            keep &= seg[b][:, None] == seg[b][None, :]
        scores = (q @ k.transpose(-1, -2) * scale).masked_fill(~keep,
                                                               -math.inf)
        m = scores.amax(-1, keepdim=True)
        p = torch.where(keep, torch.exp(scores - m), 0.0)
        l = p.sum(-1, keepdim=True)
        plain = {"o": (p @ v) / l}
        kernel = {"o": (operand(p) @ v) / l}
        p = torch.where(keep, torch.exp(scores - m - torch.log(l)), 0.0)
        delta = (do * plain["o"].to(dt).float()).sum(-1, keepdim=True)
        ds = p * (do @ v.transpose(-1, -2) - delta)
        plain.update(dq=ds @ k * scale,
                     dk=ds.transpose(-1, -2) @ q * scale,
                     dv=p.transpose(-1, -2) @ do)
        kernel.update(dq=operand(ds * scale) @ k,
                      dk=operand(ds).transpose(-1, -2) @ q * scale,
                      dv=operand(p).transpose(-1, -2) @ do)
        for name, want in plain.items():
            floor = want.abs().clamp(min=1.0)
            err = ((kernel[name] - want).abs() / floor).max().item()
            ulps[name] = max(ulps.get(name, 0.0), err / ULP_AT_1[dtype])
            got16, want16 = kernel[name].to(dt).float(), want.to(dt).float()
            err16 = ((got16 - want16).abs()
                     / want16.abs().clamp(min=1.0)).max().item()
            over_tol[name] = max(over_tol.get(name, 0.0), err16 / TOL[dtype])
    return {"float_error_ulps": ulps, "error_over_tolerance": over_tol}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=sorted(TOL), default="bfloat16")
    ap.add_argument("--mode", choices=("single", "split"), default="split")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--no-segments", action="store_true")
    args = ap.parse_args(argv)
    result = {"dtype": args.dtype, "mode": args.mode, "seed": args.seed,
              "segments": not args.no_segments}
    result.update(rounding_errors(args.dtype, args.mode, args.seed,
                                  args.batch, not args.no_segments))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

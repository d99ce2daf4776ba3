"""The numerics of the 16-bit flash kernels' design, on the CPU.

K1's bfloat16 / float16 kernels (``csrc/flash_common.cuh``) run their
tile products in ``mma.sync`` m16n8k16 on 16-bit operands with float32
sums. q, k, v and dO are 16-bit already; p and dS come out of float32
accumulators, and the kernels split each into ``hi`` (rounded to the
dtype) and ``lo`` (the rest, rounded) and take two MMAs. No card runs
here, so this file repeats the products in float32 with those operands
(``scripts/flash16_rounding.py``) on seeded packed-segment inputs and
pins what the design relies on:

* with the split, the float32 results before the output's own rounding
  sit within a few thousandths of an output ulp of the plain products,
  so the kernels stay within ``chip_smoke.py``'s tolerances (1e-2 for
  bfloat16, 2e-3 for float16, relative to max(1, |plain|)) by the
  margin of the output rounding alone;
* p and dS rounded once (one MMA) err by a large part of an ulp already
  at this small size; at the training shape that is up to 1.25 ulps,
  past the bfloat16 limit (the script, ``--mode single --seed 5``).
"""
import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "flash16_rounding",
    Path(__file__).resolve().parent.parent / "scripts" / "flash16_rounding.py")
rounding = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(rounding)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("segments", [True, False])
def test_split_keeps_the_16bit_contract(dtype, segments):
    split = rounding.rounding_errors(dtype, "split", seed=1, batch=2,
                                     segments=segments, heads=2, s_len=256)
    single = rounding.rounding_errors(dtype, "single", seed=1, batch=2,
                                      segments=segments, heads=2, s_len=256)
    assert max(split["float_error_ulps"].values()) < 0.01, split
    assert max(split["error_over_tolerance"].values()) <= 1.0, split
    # rounding p and dS once costs two orders of magnitude more
    assert max(single["float_error_ulps"].values()) > 0.3, single

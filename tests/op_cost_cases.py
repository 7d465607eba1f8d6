"""The port's decode-step counts (`repro_torch.core.plan_search
.block_costs`, counted by `repro_torch.roofline.op_cost`) against the
reference's (`repro.core.plan_search.block_costs`, counted by
`repro.roofline.jaxpr_cost` under `pinned_impl("ref")`), for the two
op_cost test files.  A helper module, not a test file.

FLOPs, the prefill FLOPs, the weight bytes and the MoE active share are
equal.  The bytes part, by these terms (each measured per lane at
cache_len 512, the port's count minus the reference's):

  * the reference's scan writes every cache leaf of the layer stack once
    as a stacked output (`jaxpr_cost.py:111-121`, e.g. 11,857,920 B a
    lane for smollm-135m), and round-trips its carries (69,120 B); the
    port writes only the new row of each cache in place (index_put_ or a
    slice copy) and has no carries;
  * the port's plain decode attention (`kernels/ref.py` flash_decode)
    takes K and V as f32 copies, so its two products read 4-byte keys
    and values where the reference's dot reads bf16 (+12,418,560 B a
    lane for smollm-135m: nearly the first term, so the totals part by
    2.1%); the card's kernel reads bf16;
  * xlstm-1.3b's mLSTM matrix state C (4 heads x 512 x 1,024 f32, 8.4 MB
    a lane and layer) is written in place, 2x the moved state, where the
    reference's scan outputs it once: +352 MB a lane of its 1,068 MB;
  * the decode products themselves (mm against the reference's
    dot_general) and gathers part by under 1 MB a lane.

bytes_fixed (at ~1e-6 of the weight stream) is held within 1e-5, and
bytes_per_lane within the measured share below, rounded up.
"""
import dataclasses

from repro.configs import get_config as jget
from repro.core import plan_search as jps
from repro.kernels.ops import pinned_impl
from repro_torch.configs import get_config
from repro_torch.core import plan_search as tps

EXACT = ("flops_fixed", "flops_per_lane", "prefill_flops_per_tok",
         "weight_bytes_bf16", "moe_active_frac")
BYTES_FIXED_REL = 1e-5
# |port - reference| / reference of bytes_per_lane, measured on this
# counter: deepseek-coder-33b 0.0257, internvl2-1b 0.0438, minitron-8b
# 0.0159, musicgen-medium 0.0092, phi3-medium-14b 0.0160, recurrentgemma-2b
# 0.0223, smollm-135m 0.0212 (the first two terms), llama4 0.0072,
# moonshot -0.0008 (their expert stream dwarfs the cache), xlstm-1.3b
# 0.3299 (the third)
BYTES_PER_LANE_REL = {"xlstm-1.3b": 0.34}
BYTES_PER_LANE_REL_DEFAULT = 0.05


def check_block_costs(arch: str) -> None:
    got = dataclasses.asdict(tps.block_costs(get_config(arch)))
    with pinned_impl("ref"):
        want = dataclasses.asdict(jps.block_costs.__wrapped__(jget(arch)))
    for k in EXACT:
        assert got[k] == want[k], (arch, k, got[k], want[k])
    rel = abs(got["bytes_fixed"] - want["bytes_fixed"]) / want["bytes_fixed"]
    assert rel <= BYTES_FIXED_REL, (arch, "bytes_fixed", rel)
    rel = (abs(got["bytes_per_lane"] - want["bytes_per_lane"])
           / want["bytes_per_lane"])
    tol = BYTES_PER_LANE_REL.get(arch, BYTES_PER_LANE_REL_DEFAULT)
    assert rel <= tol, (arch, "bytes_per_lane", rel)

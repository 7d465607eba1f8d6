"""Print the plan search's choice for every decoder config x four traffic
profiles (the reference's default; devices 1, 2 and 4 at 80 GB), four
ways, as one markdown table (a script, not collected by pytest; CPU,
JAX and PyTorch, ~4 min):

  jax-default  the reference's `search` with its default kernel impl
               (the Pallas bodies in interpret mode on the CPU, whose
               count leaves attention over the cache out)
  jax-ref      the reference's scoring on its counts under
               `pinned_impl("ref")` (the plain jnp versions)
  port-v5e     the port's scoring on those ref-impl counts, under the
               reference's TPU v5e table (equal to jax-ref by
               tests/test_torch_plan_search.py)
  port-h100    the port's own `search`: its fake-tensor counts and the
               H100 table, each profile at the card's memory

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/plan_choices.py
"""
import dataclasses

from repro.configs import get_config as jget
from repro.core import plan_search as jps
from repro.kernels.ops import pinned_impl
from repro_torch.configs import get_config, list_archs
from repro_torch.core import plan_search as tps

PROFILES = [("default", {})] + [(f"d{n}", dict(devices=n, hbm_gb=80.0))
                                for n in (1, 2, 4)]


def _key(res):
    return res.chosen.key if res.chosen is not None else "none feasible"


def main():
    print("| config | profile | jax-default | jax-ref | port-v5e | "
          "port-h100 |")
    print("|---|---|---|---|---|---|")
    for arch in list_archs():
        if arch == "ibert-base":
            continue
        jcfg, cfg = jget(arch), get_config(arch)
        with pinned_impl("ref"):
            jcosts = jps.block_costs.__wrapped__(jcfg)
        jhw = jps.HardwareModel()
        for name, over in PROFILES:
            jprof = dataclasses.replace(jps.TrafficProfile(), **over)
            default = _key(jps.search(jcfg, jprof))
            scores = [jps.score_candidate(jcfg, c, jprof, jhw, jcosts)
                      for c in jps.enumerate_candidates(jcfg, jprof)]
            ref = jps.choose(scores, jprof)
            prof = tps.TrafficProfile.from_dict(jprof.to_dict())
            costs = tps.BlockCosts(**dataclasses.asdict(jcosts))
            port = [tps.score_candidate(cfg, c, prof,
                                        tps.HardwareModel(
                                            **dataclasses.asdict(jhw)),
                                        costs)
                    for c in tps.enumerate_candidates(cfg, prof)]
            v5e = tps.choose(port, prof)
            # the H100 column: the port's defaults, the card's memory
            # where the profile names 80 GB
            h100_over = {k: v for k, v in over.items() if k != "hbm_gb"}
            h100 = _key(tps.search(cfg, tps.TrafficProfile(**h100_over)))
            print(f"| {arch} | {name} | {default} | "
                  f"{ref.key if ref else 'none feasible'} | "
                  f"{v5e.key if v5e else 'none feasible'} | {h100} |",
                  flush=True)


if __name__ == "__main__":
    main()

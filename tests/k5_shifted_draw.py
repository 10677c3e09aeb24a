"""K5 (the batched solver's replay kernel) against its plain version on two
draws of ``chip_smoke.py``'s Panda problem at phase 9's widths, on the card.

``chip_smoke.py`` phases 7-9 draw the Panda problem from one generator
after phases 3-5. Phase 6b draws from its own; had it drawn from that one,
phases 7-9 would solve other scenarios (``shifted``). For each draw, each
form of K2 the solve may run (``emitted``, ``looped``: the same scenarios,
solved on each form's linearization) and each of phase 9's widths this
script solves the batch as phase 9 does,
feeds K5 and its plain version the same inputs (the solve's controls, K2's
and K3's outputs at reg 1e-6, an alpha of 0.5^(b mod 6) for scenario b),
and reports, per output, the entries that are not finite on each side,
whether the two sides hold NaN in the same places and their largest |d|
elsewhere, and which scenarios carry non-finite gains.

Not collected by pytest. Run on a card from the repository's root:

    PYTHONPATH=. python tests/k5_shifted_draw.py [OUT_DIR]

Prints one line a case and writes them to ``OUT_DIR/k5_shifted_draw.json``
(OUT_DIR: ``build``, which git ignores).
"""

import json
import os
import sys

import torch

import chip_smoke as cs
from manipulapy_tpu_torch.models import catalog
from manipulapy_tpu_torch.mpc.fused_batch import build_batch_tracking_mpc


def phase9_generator(panda, shifted: bool) -> torch.Generator:
    """The smoke's generator as phase 9 finds it: phases 3-5's draws, phase
    6b's too when ``shifted``, then phases 7 and 8's."""
    gen = torch.Generator(cs.DEV).manual_seed(0)
    for name, _, B, N in cs.ROLLOUT_CASES:
        cs.inputs(gen, B, N, 7 if name == "panda" else 6)
    cs.inputs(gen, cs.B_FULL, cs.N_FULL, 6)
    for _ in range(2):
        torch.rand((cs.B_PIPELINE, 6), generator=gen, device=cs.DEV)
    if shifted:
        for n in (6, 7):  # the programmatic UR5's and Panda's inputs
            cs.inputs(gen, cs.B_FULL, cs.N_FULL, n)
    cs.panda_problem(gen, panda, cs.B_PARITY)
    torch.rand((cs.H_PARITY, 7, cs.B_PARITY), generator=gen, device=cs.DEV)
    for _ in range(1 + 1 + 3):  # phase 7's solve, phase 8's solve and its 3 rounds
        cs.panda_problem(gen, panda, cs.B_MPC)
    return gen


def nonfinite(t: torch.Tensor) -> int:
    return int((~torch.isfinite(t)).sum())


def case(panda, gen, B: int, form: str) -> dict:
    f32 = dict(dtype=torch.float32, device=cs.DEV)
    x0, goals = cs.panda_problem(gen, panda, B)
    handle = build_batch_tracking_mpc(panda, goals, B, cs.H_MPC, cs.DT, iterations=cs.ITERS, _form=form)
    K = handle.kernels
    us, _, cost = handle.solve(x0, torch.zeros((B, cs.H_MPC, 7), **f32))
    args = cs.mpc_stage_parity(K, x0, goals, us.permute(1, 2, 0).contiguous(), f"panda B={B}", False, check=False)[1]
    kK = args["replay"][3]
    got, ref = K.replay(*args["replay"]), K.replay_plain(*args["replay"])
    torch.cuda.synchronize()
    bad_gains = (~torch.isfinite(kK)).flatten(0, 2).any(0)
    bad_ref = (~torch.isfinite(ref[2]))
    out = {
        "B": B, "solve_cost_nonfinite": nonfinite(cost), "solve_controls_nonfinite": nonfinite(us),
        "gain_scenarios_nonfinite": bad_gains.nonzero().flatten().tolist()[:32],
        "ref_cost_scenarios_nonfinite": bad_ref.nonzero().flatten().tolist()[:32],
        "alphas_of_those": [0.5 ** (b % cs.ALPHAS) for b in bad_ref.nonzero().flatten().tolist()[:32]],
    }
    for name, g, r in zip(("xs", "us", "cost"), got, ref):
        out[name] = {"got_nonfinite": nonfinite(g), "ref_nonfinite": nonfinite(r),
                     "same_nan_places": bool(torch.equal(torch.isnan(g), torch.isnan(r))),
                     "bit_diff": cs.bit_diff(g, r)}
    return out


def main(out_dir: str = "build") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("k5_shifted_draw: no CUDA device is available")
    panda = catalog.panda(dtype=torch.float32)
    results = {"card": cs.card_line()}
    for shifted in (False, True):
        for form in cs.LIN_FORMS:
            gen = phase9_generator(panda, shifted)
            for B in cs.B_MPC_WIDE:
                r = case(panda, gen, B, form)
                draw = "shifted" if shifted else "smoke"
                results[f"{draw} {form} B={B}"] = r
                print(f"[k5_draw] draw={draw} k2={form} {json.dumps(r)}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "k5_shifted_draw.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main(*sys.argv[1:2])

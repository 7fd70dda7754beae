"""chip_smoke.py's card vs CPU rule through the sign_max merge
(``SignMaxTap``, ``sign_max_rule``, ``passes``), exercised on the CPU: a
second CPU forward stands in for the card, with its merge inputs moved by
hand at chosen elements.  The tiny two-branch flagship (channels (4, 4, 8),
part_dim 8), B = 4, inputs from a numpy seed.  And chip_smoke.py's phase
registry (``plan``, ``--phase``, ``kernel_entries``), pure Python.
"""

import copy

import numpy as np
import pytest
import torch

import chip_smoke as C
from ugaitnet_tpu_torch.core.config import BranchConfig, ModelConfig
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops import fusion

torch.set_num_threads(1)

KEYS = ("signature", "classprob_logits")


@pytest.fixture(scope="module")
def net():
    kw = dict(kind="gaitset", gaitset_channels=(4, 4, 8), part_dim=8)
    cfg = ModelConfig(branches=(BranchConfig(modality="of", **kw),
                                BranchConfig(modality="gray", **kw)),
                      merge="sign_max", nclasses=4)
    model = UGaitNet(cfg, device="cpu", seed=0)
    model.eval()
    rng = np.random.RandomState(0)
    vols = [torch.from_numpy(rng.randn(4, 25, 60, 60, c).astype(np.float32))
            for c in (2, 1)]
    flags = [torch.ones(4), torch.ones(4)]
    with torch.inference_mode(), C.SignMaxTap() as tap:
        out = model(vols, flags)
    want = {k: out[k] for k in KEYS}
    return model, vols, flags, want, tap.calls


def card(model, vols, flags, moved=None):
    """A forward standing in for the card: ``moved(first)`` edits the first
    branch's gated embedding before the merge."""
    other = copy.deepcopy(model)
    hook = None
    if moved is not None:
        hook = other.branches["branch_of"].register_forward_hook(
            lambda mod, args, out: moved(out))

    def run():
        with torch.inference_mode():
            out = other(vols, flags)
        return {k: out[k] for k in KEYS}
    return run, hook


def test_sign_max_tap_records_forces_and_restores(net):
    model, vols, flags, want, calls = net
    merge = fusion.MERGES["sign_max"]
    (a, b, picks), = calls
    assert torch.equal(picks, a.abs() >= b.abs())
    run, _ = card(model, vols, flags)
    with C.SignMaxTap(force=[picks]):
        same = run()
    flipped = picks.clone()
    flipped[1, 2, 3] = ~flipped[1, 2, 3]
    with C.SignMaxTap(force=[flipped]):
        other = run()
    assert fusion.MERGES["sign_max"] is merge
    for k in KEYS:
        assert torch.equal(same[k], want[k])
    # one forced pick moves its batch-axis L2 column (part 2, element 3)
    diff = (other["signature"] - want["signature"]).abs()
    assert float(diff[:, 2, 3].min()) > 0
    diff[:, 2, 3] = 0
    assert float(diff.max()) == 0


def _nearest_tie(a, b):
    gap = (a.abs() - b.abs()).abs()
    return np.unravel_index(int(gap.argmin()), tuple(gap.shape))


def test_sign_max_rule_accounts_for_a_switched_pick(net):
    model, vols, flags, want, calls = net
    (a, b, picks), = calls
    idx = _nearest_tie(a, b)
    scale = float(torch.maximum(a.abs().max(), b.abs().max()))
    gap = float((a.abs() - b.abs()).abs()[idx])
    assert gap <= C.CPU_REL / 1.2 * scale   # a near tie to move across
    # the first branch's magnitude moved just across the second's
    step = 1.01 * gap * (1.0 if abs(a[idx]) < abs(b[idx]) else -1.0)
    step = step * (1.0 if a[idx] >= 0 else -1.0)

    def across(out):
        out = out.clone()
        out[idx] += step
        return out
    run, hook = card(model, vols, flags, across)
    r = C.sign_max_rule(run, want, calls)
    hook.remove()
    assert r["switched"] == 1 and r["picks"] == picks.numel()
    assert r["near"] >= 1
    assert r["tie"] == pytest.approx(gap / scale, rel=1e-3)
    assert r["branches"] == pytest.approx(1.01 * gap / float(a.abs().max()),
                                          rel=1e-3)
    for k in KEYS:
        assert r["forced"][k] <= C.CPU_REL
        assert C.passes(r, k)
    # the switched pick alone puts the raw reading over the limit
    assert r["raw"]["signature"] > C.CPU_REL


@pytest.mark.parametrize("fault", ["far from a tie", "merge inputs",
                                   "after the merge"])
def test_sign_max_rule_fails_planted_faults(net, fault):
    """The rule fails each planted fault: a pick switched where the two
    magnitudes lie far apart (the merge inputs moved there alone), a merge
    input moved by 1e-2 of max without switching a pick, and the outputs
    moved after the merge (the inputs and picks untouched)."""
    model, vols, flags, want, calls = net
    (a, b, picks), = calls
    scale = float(torch.maximum(a.abs().max(), b.abs().max()))
    far = np.unravel_index(int((a.abs() - b.abs()).abs().argmax()),
                           tuple(a.shape))
    hook = None
    if fault == "after the merge":
        run0, _ = card(model, vols, flags)

        def run():
            out = run0()
            return {k: v * (1 + 1e-2) for k, v in out.items()}
    else:
        def moved(out):
            out = out.clone()
            if fault == "far from a tie":
                out[far] = out[far] * 1e-3 if picks[far] else \
                    out[far].sign() * scale
            else:
                keep = (picks & (a.abs() > 2e-2 * scale)).nonzero()[0]
                keep = tuple(int(i) for i in keep)
                out[keep] += 1e-2 * scale * out[keep].sign()
            return out
        run, hook = card(model, vols, flags, moved)
    r = C.sign_max_rule(run, want, calls)
    if hook is not None:
        hook.remove()
    if fault == "far from a tie":
        assert r["switched"] == 1 and r["tie"] > C.CPU_REL
    elif fault == "merge inputs":
        assert r["switched"] == 0 and r["branches"] > C.CPU_REL
    else:
        assert r["branches"] == 0 and r["switched"] == 0
    for k in KEYS:
        assert not C.passes(r, k)


EVERY_PHASE = ["1", "1b", "1c", "1d", "1e", "1f", "2", "3", "4", "sets", "5",
               "6", "7", "8", "9", "10", "11", "batch", "12", "13", "14"]


@pytest.mark.parametrize("phase, want", [
    ("13", ["3", "sets", "7", "batch", "13"]),
    ("", EVERY_PHASE),
    ("1e,1e,1f", ["1e", "1f"]),
    ("1d,1c", ["1c", "1d"]),
    ("8", ["3", "sets", "6", "7", "8"]),
    ("14", ["14"])])
def test_phase_plan(phase, want):
    """The named phases in the registry's order, after the phases they
    need; every phase when none is named; a name named twice once."""
    names = [n for n in phase.split(",") if n]
    assert [p.name for p in C.plan(names)] == want


@pytest.mark.parametrize("phase", ["99", "1g", "13,x"])
def test_unknown_phase_is_refused_with_the_known_names(phase, capsys):
    with pytest.raises(SystemExit) as e:
        C.main(["--phase", phase])
    assert e.value.code == 2
    assert f"the phases: {', '.join(EVERY_PHASE)}" in capsys.readouterr().err


@pytest.mark.parametrize("i", range(len(C.PHASES)))
def test_needs_come_first(i):
    """A phase's producers stand before it, so a plan in the registry's
    order runs them first."""
    before = [p.name for p in C.PHASES[:i]]
    assert all(n in before for n in C.PHASES[i].needs)


@pytest.mark.parametrize("ran", ["1e", "1f"])
def test_kernel_entry_leaves_out_what_did_not_run(ran):
    """A kernel whose phase ran alone gets no count from the phases that
    did not run, not a zero."""
    by = "by_shape" if ran == "1e" else "by_conv"
    res = {k: 1.0 for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                            "library_ms", "share_of_bound",
                            "factor_to_library")}
    res.update(bound_by="bytes", launches=4, **{by: {"a": {"ms": 1.0}}})
    entry, = C.kernel_entries({ran: res})
    g = "wgrad" if ran == "1e" else "dgrad"
    assert entry["name"] == f"conv3d_{g}" and "launches" not in entry
    assert entry["launches_by_path"] == {f"{g}_phase": 4}
    assert entry[by]["a"]["ms"] == 1.0
    assert entry[by]["a"]["max_rel_err"] is None

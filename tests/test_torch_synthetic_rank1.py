"""The port's convergence run (``ugaitnet_tpu_torch/eval/synthetic_rank1.py``)
held against the JAX script ``benchmarks/synthetic_rank1.py`` on the CPU.

Both scripts run as they are; only the objects they call are replaced for
the duration of a test (``monkeypatch``), so the recipe and the scoring are
read from the two ``run`` functions themselves:

  * recipe: the datasets' arguments, the model, data, train and eval
    configurations, the fit's and the encodes' arguments, field by field
    against the JAX package's dataclasses (at full width, against the JAX
    recipe with the flagship's branches, ``__graft_entry__.py:20-26``); the
    two datasets bitwise.
  * scoring, at 3 identities (27 eval clips, one padded encode batch of
    32 a sweep; 4 identities take two, ~39 s of this file's durations in
    the Tier-1 run): the trainer's fit returns the same weights to both
    runs (the port's seed-0 init in the flax layout to JAX, carried back
    through ``utils/weights.py:flax_to_state_dict`` to the port), so both
    runs encode, sweep and score the same weights and data.  Codes within
    the forward tolerance of ``tests/test_torch_eval.py`` (rtol 1e-4 /
    atol 1e-5), every sweep's Rank-1 equal, EER within 1e-6 (the JAX
    script's ``_rank1_eer`` is the oracle).  A gallery taken from the
    of_only sweep's codes instead of the full one's must fail that
    comparison.
  * ``slow``: the port's 16-identity run trained on the CPU against
    ``tests/test_convergence_rank1.py``'s limits.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from benchmarks import synthetic_rank1 as JR
from ugaitnet_tpu.data import synthetic as j_synthetic
from ugaitnet_tpu.eval import protocol as j_protocol
from ugaitnet_tpu.models.network import UGaitNet as JNet
from ugaitnet_tpu.train import trainer as j_trainer

from ugaitnet_tpu_torch.eval import synthetic_rank1 as TR
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.utils.weights import (flax_to_state_dict,
                                              state_dict_to_flax)

torch.set_num_threads(1)

FWD_RTOL, FWD_ATOL = 1e-4, 1e-5      # tests/test_torch_eval.py's codes
EER_ATOL = 1e-6
SCORED_IDS = 3


class _Stop(Exception):
    """Ends a recorded run at its first encode (the recipe tests)."""


def _record(monkeypatch, owners, make_model, stop):
    """Replace the run's dataset maker, Trainer and encode_set with
    recorders.  owners: (module of make_synthetic_dataset, of Trainer, of
    encode_set); make_model(mcfg) -> (model, fit result)."""
    synth_mod, trainer_mod, encode_mod = owners
    rec = {"datasets": [], "encodes": []}
    real_synth = synth_mod.make_synthetic_dataset
    real_encode = encode_mod.encode_set

    def synth(**kw):
        ds = real_synth(**kw)
        rec["datasets"].append((kw, ds))
        return ds

    class Recorder:
        def __init__(self, mcfg, dcfg, tcfg, experdir, **kw):
            rec["configs"] = (mcfg, dcfg, tcfg)
            rec["trainer_kw"] = kw
            self.device = torch.device("cpu")
            self.model, self._state = make_model(mcfg)

        def fit(self, ds, **kw):
            rec["fit"] = (ds, kw)
            return self._state

    def encode(*args, **kw):
        ds, mods, cfg = args[-3:]
        rec["ecfg"] = cfg
        rec["encodes"].append({"ds": ds, "mods": tuple(mods), **kw})
        if stop:
            raise _Stop
        out = real_encode(*args, **kw)
        rec["encodes"][-1]["out"] = out
        return out

    monkeypatch.setattr(synth_mod, "make_synthetic_dataset", synth)
    monkeypatch.setattr(trainer_mod, "Trainer", Recorder)
    monkeypatch.setattr(encode_mod, "encode_set", encode)
    return rec


def _jax_run(monkeypatch, path, params=None, **kw):
    """The JAX script's run, recorded; without params it stops at the
    first encode."""
    def make_model(mcfg):
        return JNet(mcfg), types.SimpleNamespace(params=params)
    rec = _record(monkeypatch, (j_synthetic, j_trainer, j_protocol),
                  make_model, stop=params is None)
    try:
        rec["result"] = JR.run(str(path), **kw)
    except _Stop:
        pass
    return rec


def _port_run(monkeypatch, path, params=None, **kw):
    def make_model(mcfg):
        model = UGaitNet(mcfg, device="cpu")
        if params is not None:
            model.load_state_dict(flax_to_state_dict(
                jax.tree_util.tree_map(np.asarray, params)))
        return model, types.SimpleNamespace(model=model)
    rec = _record(monkeypatch, (TR, TR, TR), make_model,
                  stop=params is None)
    try:
        rec["result"] = TR.run(str(path), device="cpu", **kw)
    except _Stop:
        pass
    return rec


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def assert_same_config(got, want):
    """Field by field, the branches' fields each."""
    assert type(got).__name__ == type(want).__name__
    a, b = _fields(got), _fields(want)
    assert a.keys() == b.keys()
    for k in b:
        if k == "branches":
            assert len(a[k]) == len(b[k])
            for x, y in zip(a[k], b[k]):
                assert_same_config(x, y)
        else:
            assert a[k] == b[k], (type(want).__name__, k, a[k], b[k])


def assert_same_dataset(got, want):
    for col in ("labels", "video_ids", "gaits", "cams", "set_ids"):
        a, b = getattr(got, col), getattr(want, col)
        assert a.dtype == b.dtype and np.array_equal(a, b), col
    assert (got.name, got.ntype) == (want.name, want.ntype)
    assert list(got.modalities) == list(want.modalities)
    for m, s in want.modalities.items():
        t = got.modalities[m]
        assert t.volumes.dtype == s.volumes.dtype
        assert np.array_equal(t.volumes, s.volumes), m
        assert np.array_equal(t.present, s.present)
        assert t.compress_factor == s.compress_factor


# --- the recipe ---------------------------------------------------------

@pytest.mark.parametrize("num_subjects,epochs,seed,full_width",
                         [(3, 20, 0, False), (2, 7, 5, True)])
def test_recipe_matches_jax_script(monkeypatch, tmp_path, full_width,
                                   num_subjects, epochs, seed):
    want = _jax_run(monkeypatch, tmp_path / "jax",
                    num_subjects=num_subjects, epochs=epochs, seed=seed)
    got = _port_run(monkeypatch, tmp_path / "port",
                    num_subjects=num_subjects, epochs=epochs, seed=seed,
                    full_width=full_width)
    jm, jd, jt = want["configs"]
    if full_width:
        # the JAX script has the tiny widths only: its recipe with the
        # flagship's branches
        jm = dataclasses.replace(jm, branches=graft._flagship_cfg().branches)
        assert jm.branches[0].gaitset_channels == (32, 64, 128)
        assert jm.branches[0].part_dim == 256
    for g, w in zip(got["configs"] + (got["ecfg"],), (jm, jd, jt,
                                                      want["ecfg"])):
        assert_same_config(g, w)
    assert got["configs"][0].nclasses == num_subjects
    assert got["trainer_kw"] == {"device": "cpu"}
    assert got["fit"][1] == want["fit"][1] == {"val_perc": 0.15,
                                               "seed": seed}
    assert len(got["datasets"]) == len(want["datasets"]) == 2
    for (gkw, gds), (wkw, wds) in zip(got["datasets"], want["datasets"]):
        assert gkw == wkw
        assert_same_dataset(gds, wds)
    train_ds, eval_ds = (ds for _, ds in got["datasets"])
    assert got["fit"][0] is train_ds
    (genc,), (wenc,) = got["encodes"], want["encodes"]
    assert genc["ds"] is eval_ds
    assert genc["mods"] == wenc["mods"] == TR.MODALITIES
    assert genc["use_mods"] == wenc["use_mods"] == TR.SWEEPS["full"]
    assert list(TR.SWEEPS.items()) == list(JR.SWEEPS.items())


def test_run_takes_the_card_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.run(str(tmp_path / "exp"), num_subjects=2, epochs=1)


def test_main_writes_the_result(monkeypatch, tmp_path, capsys):
    calls = []

    def run(experdir, **kw):
        calls.append(kw)
        return {"rank1_subseq": 1.0, "sweeps": {}}
    monkeypatch.setattr(TR, "run", run)
    out = tmp_path / "r.json"
    TR.main(["--num-subjects", "5", "--epochs", "3", "--full-width",
             "--device", "cpu", "--out", str(out)])
    assert calls == [dict(num_subjects=5, epochs=3, device="cpu",
                          full_width=True)]
    with open(out) as f:
        assert json.load(f) == {"rank1_subseq": 1.0, "sweeps": {}}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == {"rank1_subseq": 1.0, "sweeps": {}}
    TR.main(["--out", str(out)])
    assert calls[-1] == dict(num_subjects=64, epochs=20, device=None,
                             full_width=False)


# --- the scoring ----------------------------------------------------------

@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """Both runs at SCORED_IDS identities on the same untrained weights."""
    mcfg = _jax_recipe_model(SCORED_IDS)
    # the port's seed-0 init in the flax layout: a compiled JAX init would
    # cost ~6 s of this file's Tier-1 time; the bridge is bitwise both ways
    # (tests/test_torch_port.py)
    tree = state_dict_to_flax(UGaitNet(
        TR.recipe(SCORED_IDS, 20)[0], device="cpu", seed=0).state_dict())
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tmp = tmp_path_factory.mktemp("scored")
    with pytest.MonkeyPatch.context() as mp:
        want = _jax_run(mp, tmp / "jax", params=params,
                        num_subjects=SCORED_IDS)
    assert_same_config(want["configs"][0], mcfg)
    with pytest.MonkeyPatch.context() as mp:
        got = _port_run(mp, tmp / "port", params=params,
                        num_subjects=SCORED_IDS)
    return want, got


def _jax_recipe_model(num_subjects):
    """The JAX script's model configuration (as the recipe test reads it)."""
    tiny = graft._flagship_cfg(tiny=True)
    return dataclasses.replace(tiny, nclasses=num_subjects)


def agrees(got, want):
    """Every sweep's Rank-1 equal, its EER within EER_ATOL."""
    return set(got) == set(want) and all(
        got[s]["rank1_subseq"] == want[s]["rank1_subseq"]
        and got[s]["rank1_video"] == want[s]["rank1_video"]
        and abs(got[s]["eer"] - want[s]["eer"]) <= EER_ATOL for s in want)


@pytest.mark.parametrize("sweep", list(TR.SWEEPS))
def test_sweep_codes_match(scored, sweep):
    want, got = scored
    i = list(TR.SWEEPS).index(sweep)
    wenc, genc = want["encodes"][i], got["encodes"][i]
    assert wenc["use_mods"] == genc["use_mods"] == TR.SWEEPS[sweep]
    a, b = genc["out"], wenc["out"]
    assert a.codes.shape == b.codes.shape == (9 * SCORED_IDS, 62 * 16)
    np.testing.assert_allclose(a.codes, b.codes, rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    for col in ("labels", "video_ids", "cams"):
        assert np.array_equal(getattr(a, col), getattr(b, col))


def test_scores_match_rank1_eer(scored):
    want, got = scored
    w, g = want["result"], got["result"]
    print(json.dumps({"jax": w["sweeps"], "port": g["sweeps"]}))
    assert agrees(g["sweeps"], w["sweeps"]), (g["sweeps"], w["sweeps"])
    skip = ("train_seconds", "encode_eval_seconds", "sweeps", "eer")
    assert {k: v for k, v in g.items() if k not in skip} == \
        {k: v for k, v in w.items() if k not in skip}
    assert g["probe_subseqs"] == 3 * SCORED_IDS


def test_rank1_eer_matches_on_the_same_codes(scored):
    """The port's rank1_eer against the JAX script's _rank1_eer on the JAX
    run's codes: equal."""
    want, _ = scored
    full = want["encodes"][0]["out"]
    gal = np.where(full.cams != 0)[0]
    for enc in (e["out"] for e in want["encodes"]):
        pr = np.where(enc.cams == 0)[0]
        jg, jp = (j_protocol.EncodedSet(e.codes[s], e.labels[s],
                                        e.video_ids[s], e.cams[s])
                  for e, s in ((full, gal), (enc, pr)))
        tg, tp = (TR.EncodedSet(e.codes[s], e.labels[s], e.video_ids[s],
                                e.cams[s])
                  for e, s in ((full, gal), (enc, pr)))
        assert TR.rank1_eer(tg, tp, device="cpu") == JR._rank1_eer(jg, jp)


def test_gallery_from_the_wrong_sweep_is_caught(scored):
    """A planted fault: the gallery from the of_only sweep's codes."""
    want, got = scored
    encs = {s: e["out"] for s, e in zip(TR.SWEEPS, got["encodes"])}
    wrong = encs["of_only"]
    gal = np.where(wrong.cams != 0)[0]
    gallery = TR.EncodedSet(wrong.codes[gal], wrong.labels[gal],
                            wrong.video_ids[gal], wrong.cams[gal])
    faulty = {}
    for s, enc in encs.items():
        pr = np.where(enc.cams == 0)[0]
        faulty[s] = TR.rank1_eer(
            gallery, TR.EncodedSet(enc.codes[pr], enc.labels[pr],
                                   enc.video_ids[pr], enc.cams[pr]),
            device="cpu")
    assert agrees(got["result"]["sweeps"], want["result"]["sweeps"])
    assert not agrees(faulty, want["result"]["sweeps"]), faulty


# --- convergence --------------------------------------------------------

@pytest.mark.slow
def test_port_converges_to_rank1(tmp_path):
    """tests/test_convergence_rank1.py:33-37's limits on the port's
    16-identity run, trained on the CPU."""
    res = TR.run(str(tmp_path / "exp"), num_subjects=16, device="cpu")
    print(json.dumps(res))
    assert res["rank1_subseq"] >= 0.9, res
    assert res["rank1_video"] >= 0.9, res
    assert res["eer"] == res["eer"] and res["eer"] <= 0.25, res
    assert set(res["sweeps"]) == {"full", "of_only", "gray_only"}

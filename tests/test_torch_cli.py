"""The port's CLIs end to end on the CPU: ``cli.train --device cpu
--synthetic --normstats`` at a tiny size, then ``cli.evaluate`` (CASIA-B
camera pairs and the open set) on a packed synthetic gallery and probe set
with the persisted standardization; the JAX package's evaluate CLI on the
same checkpoint weights (carried over by the weight bridge) and the same
``norm_stats.npz`` gives the same results JSON and the same confusion
matrices, i.e. the same predicted labels.  Flags whose paths are not
ported raise."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ugaitnet_tpu.cli import evaluate as j_evaluate
from ugaitnet_tpu.core import checkpoint as jckpt
from ugaitnet_tpu.core.config import load_json as j_load_json
from ugaitnet_tpu.train import train_step as J

from ugaitnet_tpu_torch.cli import evaluate, train
from ugaitnet_tpu_torch.core import checkpoint as ckpt
from ugaitnet_tpu_torch.data.synthetic import make_synthetic_dataset
from ugaitnet_tpu_torch.utils.weights import state_dict_to_flax

torch.set_num_threads(1)

TRAIN = ["--synthetic", "--nclasses", "4", "--bs", "8", "--repetitions", "2",
         "--epochs", "1", "--savemodelfreq", "1", "--gschannels", "4,4,8",
         "--gspartdim", "8", "--expandlevel", "1", "--mergefun", "sign_max",
         "--lr", "1e-3", "--asyncckpt", "--normstats", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    exp = train.main(TRAIN + ["--experdir", str(root / "exp")])
    kw = dict(num_subjects=4, videos_per_subject=6, subseqs_per_video=1,
              num_cams=3, template_seed=0)
    for name, seed in (("gallery", 5), ("probe", 6)):
        make_synthetic_dataset(seed=seed, name=name, **kw).save(
            str(root / name))
    return root, exp


def _jax_experiment(root, exp):
    """The port's checkpoint as a JAX experiment: its config.json and
    norm_stats.npz, and a TrainState with the bridged weights and a fresh
    optimizer state."""
    jexp = str(root / "jax_exp")
    os.makedirs(jexp, exist_ok=True)
    for name in ("config.json", "norm_stats.npz"):
        shutil.copy(os.path.join(exp, name), jexp)
    tcfg = j_load_json(os.path.join(jexp, "config.json"))["train"]
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(
        ckpt.restore_raw(exp, 1)["model"]))
    tx = J.make_optimizer(tcfg)
    jckpt.save_checkpoint(jexp, 1, J.TrainState(
        step=jnp.int32(0), params=params, opt_state=tx.init(params)))
    return jexp


def _run(main, args, capsys):
    main(args)
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):out.rindex("}") + 1])


@pytest.mark.parametrize("protocol", ["casiab", "openset"])
def test_evaluate_matches_jax_cli(trained, tmp_path, capsys, monkeypatch,
                                  protocol):
    monkeypatch.setenv("UGAITNET_CACHE_DIR", str(tmp_path / "jax_cache"))
    root, exp = trained
    assert ckpt.latest_checkpoint_step(exp) == 1 and \
        ckpt.has_best_checkpoint(exp)
    args = ["--gallery", str(root / "gallery"), "--probes",
            str(root / "probe"), "--protocol", protocol, "--knn", "1",
            "--bs", "8", "--epoch", "1"]
    evaluate.main(args + ["--experdir", exp, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "using persisted norm_stats.npz" in printed
    got = json.loads(printed[printed.index("{"):printed.rindex("}") + 1])
    want = _run(j_evaluate.main,
                args + ["--experdir", _jax_experiment(tmp_path, exp)],
                capsys)
    gconf, wconf = (np.load(r["probe"].pop("confusions_file"))
                    for r in (got, want))
    assert got == want
    if protocol == "casiab":
        assert sorted(got["probe"]) == ["0", "1", "2"]
    assert sorted(gconf.files) == sorted(wconf.files)
    for k in wconf.files:
        assert np.array_equal(gconf[k], wconf[k]), k
    rank1 = [v for r in got["probe"].values()
             for v in (r.values() if isinstance(r, dict) else [r])]
    assert all(0.0 <= v <= 1.0 for v in rank1) and max(rank1) > 0.0


def test_evaluate_best_and_results_file(trained, tmp_path):
    root, exp = trained
    out = str(tmp_path / "res.json")
    res = evaluate.main(["--experdir", exp, "--epoch", "best", "--gallery",
                         str(root / "gallery"), "--probes",
                         str(root / "probe"), "--knn", "1", "--bs", "8",
                         "--device", "cpu", "--outfile", out])
    assert json.load(open(out)) == json.loads(json.dumps(res, default=float))
    assert any(f.startswith("codes_gallery_") and "_ebest" in f
               for f in os.listdir(exp))


@pytest.mark.parametrize("flags", [["--ndevices", "2"], ["--tp", "2"],
                                   ["--sp", "2"], ["--pp", "2"],
                                   ["--ep", "2"], ["--moe", "4"],
                                   ["--remat"], ["--initnet", "x"],
                                   ["--initbranch", "of=x"],
                                   ["--datadir2", "x"]])
def test_unported_train_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(TRAIN + ["--experdir", str(tmp_path)] + flags)


def test_cli_defaults_to_the_card(trained, tmp_path):
    root, exp = trained
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main([a for a in TRAIN if a not in ("--device", "cpu")]
                   + ["--experdir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.main(["--experdir", exp, "--gallery", str(root / "gallery"),
                       "--probes", str(root / "probe")])
    with pytest.raises(NotImplementedError, match="item 12"):
        evaluate.main(["--experdir", exp, "--gallery", str(root / "gallery"),
                       "--probes", str(root / "probe"), "--dp", "2",
                       "--device", "cpu"])

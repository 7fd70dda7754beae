"""Why the port's and the JAX package's train CLIs part at lr 1e-2 (SGD)
on the tiny two-branch config, where ``tests/test_torch_trainer_parallel.py``
holds them together at lr 1e-3.

Both one-process CLIs train that file's config with its flags at lr 1e-2
(the JAX run with its ``pairwise_dist`` diagonal zeroed, as there); every
train step records the parameters it starts from, its batch and its
metrics.  Held at each step:

  * the batches are bitwise equal;
  * the port's loss at the JAX run's parameters equals the JAX step's loss
    within METRIC_RTOL = 1e-5: the two train steps compute one function;
  * wherever the free-running losses part by more than the CLI test's
    CLI_RTOL = 1e-3, a discontinuity of that function lies between the
    two runs' parameters at that step or an earlier one: a ``sign_max``
    pick that differs (two branch values of near-equal magnitude and
    opposite sign, so the fused value changes sign) or a triplet whose
    hinge changes side.

Measured on one CPU: the parameters part by 2.0e-7 of their largest entry
after one step and by 6.3e-5 after six (SGD at lr 1e-2 amplifies the two
frameworks' float32 rounding); at step 6 one ``sign_max`` pick switches
(|of| 0.00577186 vs |gray| 0.00577083 at JAX's parameters, 0.00577059 vs
0.00577087 at the port's) and the step's loss parts by 3.7 %, epoch 2's
train loss by 0.9 %; the port at JAX's parameters stays within 7.6e-7 at
every step.  At lr 1e-3 the parameters stay within 8.3e-7 over the same
8 steps and no pick switches.
"""

import jax
import numpy as np
import pytest
import torch

from ugaitnet_tpu.cli import train as j_train
from ugaitnet_tpu.ops import triplet as JT
from ugaitnet_tpu.train import trainer as JTR

from test_torch_parallel import _exact_diagonal_dist
from test_torch_trainer_parallel import CLI_RTOL, FLAGS, _init_experiments
from ugaitnet_tpu_torch.cli import train
from ugaitnet_tpu_torch.models.network import UGaitNet
from ugaitnet_tpu_torch.ops.triplet import pairwise_dist
from ugaitnet_tpu_torch.train import trainer as TTR
from ugaitnet_tpu_torch.train.train_step import Batch, compute_losses
from ugaitnet_tpu_torch.utils.weights import flax_to_state_dict

torch.set_num_threads(1)

METRIC_RTOL = 1e-5
LR_FLAGS = FLAGS[:FLAGS.index("--lr")] + ["--lr", "1e-2"] \
    + FLAGS[FLAGS.index("--lr") + 2:]


def _recording(make, records, read):
    """``make`` with each step's (parameters, batch, metrics) appended to
    ``records``; ``read(state, batch)`` takes the first two."""
    def make_recording(*args, **kw):
        step = make(*args, **kw)

        def recorded(state, batch, *rest):
            params, arrays = read(state, batch)
            state, metrics = step(state, batch, *rest)
            records.append((params, arrays,
                            {k: float(v) for k, v in metrics.items()}))
            return state, metrics
        return recorded
    return make_recording


def _port_read(state, batch):
    return ({k: v.detach().clone() for k, v in
             state.model.state_dict().items()},
            [t.numpy().copy() for t in (*batch.volumes, *batch.use_flags,
                                        batch.labels)])


def _jax_read(state, batch):
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    return (flax_to_state_dict(params),
            [np.asarray(t) for t in (*batch.volumes, *batch.use_flags,
                                     batch.labels)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("drift")
    port_init, jax_init = _init_experiments(root, [])
    port, jax_rec = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TTR, "make_train_step",
                   _recording(TTR.make_train_step, port, _port_read))
        mp.setattr(JTR, "make_train_step",
                   _recording(JTR.make_train_step, jax_rec, _jax_read))
        mp.setenv("UGAITNET_CACHE_DIR", str(root / "jax_cache"))
        train.main(LR_FLAGS + ["--initnet", port_init, "--device", "cpu",
                               "--experdir", str(root / "port")])
        mp.setattr(JT, "pairwise_dist", _exact_diagonal_dist)
        j_train.main(LR_FLAGS + ["--initnet", jax_init,
                                 "--experdir", str(root / "jax")])
    mcfg, _, tcfg = train.configs_from_args(
        train.build_parser().parse_args(LR_FLAGS))
    return mcfg, tcfg, port, jax_rec


def _forward(mcfg, tcfg, state_dict, batch, key):
    """(loss, gated branch outputs, signature) of the port's train-mode
    loss at ``state_dict``."""
    model = UGaitNet(mcfg, device="cpu")
    model.load_state_dict(state_dict)
    model.train()
    taps = {}
    hook = model.register_forward_hook(lambda m, a, out: taps.update(out))
    with torch.no_grad():
        total, _ = compute_losses(model, batch, mcfg, tcfg, key=key)
    hook.remove()
    gated = [e * f.reshape(-1, 1, 1)
             for e, f in zip(taps["branches"], batch.use_flags)]
    return float(total), gated, taps["signature"]


def _active(sig, labels, margin):
    """Batch-all triplets (a == p included, as the loss counts them) with
    a positive hinge, (P, B, B, B)."""
    d = pairwise_dist(sig.transpose(0, 1))
    same = labels[:, None] == labels[None, :]
    valid = same[None, :, :, None] & ~same[None, :, None, :]
    return valid & (margin + d[..., :, None] - d[..., None, :] > 0)


def test_cli_parting_at_lr_1e2_is_a_discontinuity(runs):
    mcfg, tcfg, port, jax_rec = runs
    assert len(port) == len(jax_rec) > 0
    crossed = False
    for k, ((tp, tb, tm), (jp, jb, jm)) in enumerate(zip(port, jax_rec)):
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a, b, err_msg=f"step {k} batch")
        n = len(mcfg.branches)
        batch = Batch(tuple(torch.from_numpy(v) for v in tb[:n]),
                      tuple(torch.from_numpy(f) for f in tb[n:2 * n]),
                      torch.from_numpy(tb[-1]))
        at_j, gated_j, sig_j = _forward(mcfg, tcfg, jp, batch, k)
        np.testing.assert_allclose(at_j, jm["loss"], rtol=METRIC_RTOL,
                                   err_msg=f"step {k}: port at JAX params")
        _, gated_t, sig_t = _forward(mcfg, tcfg, tp, batch, k)
        picks = [g[0].abs() >= g[1].abs() for g in (gated_j, gated_t)]
        switched = int((picks[0] != picks[1]).sum())
        flipped = int((_active(sig_j, batch.labels, tcfg.margin)
                       != _active(sig_t, batch.labels, tcfg.margin)).sum())
        crossed = crossed or switched > 0 or flipped > 0
        parted = abs(tm["loss"] - jm["loss"]) / abs(jm["loss"])
        drift = max(float((tp[key] - jp[key]).abs().max()
                          / jp[key].abs().max().clamp_min(1e-30))
                    for key in jp)
        print(f"step {k}: parameters part by {drift:.2e}, loss by "
              f"{parted:.2e}; sign_max switches {switched}, hinge flips "
              f"{flipped}; port at JAX params "
              f"{abs(at_j - jm['loss']) / abs(jm['loss']):.1e}")
        if parted > CLI_RTOL:
            assert crossed, (f"step {k}: losses part by {parted:.2e} with "
                             "no discontinuity between the parameters")

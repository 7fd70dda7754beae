"""The seeded generators: the same seed gives the same inputs, and every
seed gets the same amount of work."""

import numpy as np
import torch

from portbench import traffic
from portbench.weights import make_weights

BIG = 2 ** 31 + 2 ** 30 + 12345


def test_clips_and_columns():
    a = traffic.make_clips(BIG, 5, "cpu")
    b = traffic.make_clips(BIG, 5, "cpu")
    np.testing.assert_array_equal(a["of"], b["of"])
    assert a["of"].shape == (5, 50, 60, 60) and a["of"].dtype == np.int16
    assert a["gray"].shape == (5, 25, 60, 60) and a["gray"].dtype == np.uint8
    assert a["of"].min() >= -3000 and a["of"].max() < 3000
    cols = traffic.casiab_columns(74, 11, 1)
    assert len(cols["labels"]) == 8140
    assert np.bincount(cols["labels"])[1:].tolist() == [110] * 74
    assert np.bincount(cols["gaits"]).tolist() == [6 * 814, 2 * 814,
                                                    2 * 814]


def test_weights_are_seeded():
    shapes = {"a.weight": (4, 3, 3, 3), "a.bias": (4,), "p.part_proj":
              (2, 3, 5), "d.weight": (6, 7)}
    w1 = make_weights(shapes, BIG, "cpu")
    w2 = make_weights(shapes, BIG, "cpu")
    for k in shapes:
        assert torch.equal(w1[k], w2[k]) and w1[k].shape == shapes[k]
    assert not w1["a.bias"].any()
    lim = (6.0 / (27 + 36)) ** 0.5     # fans 3 * 9 and 4 * 9
    assert w1["a.weight"].abs().max() <= lim
    assert not torch.equal(make_weights(shapes, 1, "cpu")["d.weight"],
                           w1["d.weight"])

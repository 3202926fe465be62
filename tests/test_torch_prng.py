"""The port's threefry stream (bnsgcn_tpu_torch/utils/prng.py) and its BNS
draw (parallel/sampling.py) bitwise against the installed jax and the JAX
package's sampling module, on the CPU.

Every comparison is array-equal: keys and random words are integers, the
uniforms are bit patterns, the samples are indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bnsgcn_tpu.parallel import sampling as j_sampling
from bnsgcn_tpu_torch.parallel import sampling as t_sampling
from bnsgcn_tpu_torch.utils import prng

SEEDS = [0, 1, 2 ** 31 - 1]
FOLDS = [0, 5, 2 ** 32 - 1]
SIZES = [1, 8, 29711]


def _words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_is_jax_key(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  _words(jax.random.key(seed)))


@pytest.mark.parametrize("data", FOLDS)
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_is_jax_fold_in(seed, data):
    got = prng.fold_in(prng.key(seed), data)
    want = _words(jax.random.fold_in(jax.random.key(seed), data))
    np.testing.assert_array_equal(got.numpy(), want)
    # the data as a tensor, one key per element
    many = prng.fold_in(prng.key(seed),
                        torch.tensor([data, 3], dtype=torch.int64))
    np.testing.assert_array_equal(many[0].numpy(), want)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_is_jax_uniform(seed, n):
    jk = jax.random.fold_in(jax.random.key(seed), 5)
    got = prng.uniform(prng.fold_in(prng.key(seed), 5), n)
    want = jax.random.uniform(jk, (n,))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


def test_uniform_batches_over_keys():
    """Keys [R, 2] draw R rows, each its own key's stream."""
    keys = prng.fold_in(prng.key(3), torch.arange(4))
    got = prng.uniform(keys, 37)
    for r in range(4):
        want = jax.random.uniform(jax.random.fold_in(jax.random.key(3), r),
                                  (37,))
        np.testing.assert_array_equal(_bits(got[r].numpy()), _bits(want))


@pytest.mark.parametrize("bad", [-1, 2 ** 32])
@pytest.mark.parametrize("name", ["epoch", "p", "j"])
def test_fold_guard_refuses_words_out_of_range(bad, name):
    with pytest.raises(ValueError, match=f"{name}={bad} outside the uint32"):
        t_sampling._fold_guard(bad, name)
    args = {"epoch": 0, "p": 1, "j": 2}
    args[name] = bad
    with pytest.raises(ValueError, match="fold_in range"):
        t_sampling.pair_key(prng.key(0), **args)
    assert t_sampling._fold_guard(2 ** 32 - 1, name) == 2 ** 32 - 1


def test_pair_key_is_jax_pair_key():
    """One call for every ordered pair (p, j) at two epochs."""
    p, j = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    for epoch in (0, 7):
        got = t_sampling.pair_key(prng.key(11), epoch,
                                  torch.from_numpy(p.ravel()),
                                  torch.from_numpy(j.ravel()))
        for i, (pp, jj) in enumerate(zip(p.ravel(), j.ravel())):
            want = j_sampling.pair_key(jax.random.key(11), jnp.uint32(epoch),
                                       int(pp), int(jj))
            np.testing.assert_array_equal(got[i].numpy(), _words(want))


def _both_samples(seed, rows, pad_b, pad_s):
    """pair_sample of the port (one call for every row) and of the JAX
    package (one per row) for rows of (n_valid, s_valid)."""
    keys = t_sampling.pair_key(prng.key(seed), 2, torch.arange(len(rows)), 1)
    n = torch.tensor([r[0] for r in rows])
    s = torch.tensor([r[1] for r in rows])
    pos, valid = t_sampling.pair_sample(keys, n, s, pad_b, pad_s)
    want = [j_sampling.pair_sample(
        j_sampling.pair_key(jax.random.key(seed), jnp.uint32(2), i, 1),
        jnp.int32(nv), jnp.int32(sv), pad_b, pad_s)
        for i, (nv, sv) in enumerate(rows)]
    return (pos.numpy(), valid.numpy(),
            np.stack([np.asarray(w[0]) for w in want]),
            np.stack([np.asarray(w[1]) for w in want]))


def test_pair_sample_is_jax_on_padding():
    """n_valid < pad_b: the padding scores 2.0, all tied, and s_valid <
    pad_s; the rows with n_valid <= pad_s take padding positions too."""
    rows = [(3, 1), (0, 0), (16, 8), (11, 5), (5, 5)]
    pos, valid, jpos, jvalid = _both_samples(5, rows, 16, 8)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(valid, jvalid)
    for (nv, sv), p, v in zip(rows, pos, valid):
        assert (p[:sv] < nv).all() and v.sum() == sv


def test_pair_sample_is_jax_on_ties_in_a_boundary_list():
    """At a list of 29,711 boundary nodes, the 23-bit scores hold tied
    pairs: the sort must break them by the lower index as lax.top_k does."""
    pad_b = 29711
    scores = prng.uniform(t_sampling.pair_key(prng.key(5), 2, 0, 1), pad_b)
    assert len(torch.unique(scores)) < pad_b          # there are ties
    pos, valid, jpos, jvalid = _both_samples(5, [(pad_b, pad_b // 10),
                                                 (pad_b - 9, pad_b)],
                                             pad_b, pad_b)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(valid, jvalid)


def test_pair_sample_is_jax_on_forced_ties(monkeypatch):
    """Scores forced to [.5, .1, .5, .1, .9, .9, .9] in both packages (the
    first row's n_valid = 4 turns the last three into padding's 2.0): jax's
    top_k gives [1 3 0 2 4 5]; torch.topk would not (it gives 6 before 4
    on the CPU), the port's stable sort does."""
    forced = np.array([.5, .1, .5, .1, .9, .9, .9], np.float32)
    monkeypatch.setattr(prng, "uniform",
                        lambda k, n: torch.from_numpy(forced[:n]).expand(
                            k.shape[0], n))
    monkeypatch.setattr(jax.random, "uniform",
                        lambda k, shape: jnp.asarray(forced[:shape[0]]))
    pos, valid, jpos, jvalid = _both_samples(0, [(4, 3), (7, 6)], 7, 6)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(pos[0], [1, 3, 0, 2, 4, 5])

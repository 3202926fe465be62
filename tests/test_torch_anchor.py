"""The calibrated accuracy anchor in the port (bnsgcn_tpu_torch/anchor.py)
against the JAX package's (tests/test_accuracy_anchor.py,
tools/anchor_harness.py), on the CPU.

  * the anchor's graph and gates are the JAX package's: the same
    reddit_like_graph arrays, the same epochs, bands and tolerance;
  * the harness trains through the port's entry point and returns a
    full-rate validation accuracy (a short run);
  * the gate itself, slow as the JAX one is (200 epochs): exact at P=1 in
    the band, and the TPU recipe's quantized stack at P=4 and rate 0.1
    within 0.005 of it; the biased-sampler mutation at P=4 and rate 0.1
    lands below exact - 0.05 (tests/test_accuracy_anchor.py:99).
    chip_smoke.py's [anchor] phase runs the same gates on the card.
"""

import numpy as np
import pytest

from bnsgcn_tpu_torch import anchor


def test_anchor_graph_and_gates_are_the_jax_ones():
    import tests.test_accuracy_anchor as j_anchor
    from bnsgcn_tpu.data.graph import reddit_like_graph as j_reddit_like
    assert anchor.ANCHOR_GRAPH == j_anchor.ANCHOR_GRAPH
    assert anchor.EPOCHS == j_anchor.EPOCHS
    assert anchor.EXACT_BAND == (0.93, 0.985)
    assert anchor.QUANT_TOL == 0.005
    g, jg = anchor.anchor_graph(), j_reddit_like(**j_anchor.ANCHOR_GRAPH)
    for k in ("src", "dst", "feat", "label", "train_mask", "val_mask",
              "test_mask"):
        np.testing.assert_array_equal(getattr(g, k), getattr(jg, k), k)


def test_harness_trains_and_scores_on_cpu(tmp_path):
    """A short P=1 run of the harness on a small twin of the anchor graph:
    it trains through run.run_training and returns the validation
    accuracy of the final parameters, above chance."""
    from bnsgcn_tpu_torch.data.graph import reddit_like_graph
    kw = dict(anchor.ANCHOR_GRAPH, n_nodes=512, avg_degree=16)
    g = reddit_like_graph(**kw)
    acc = anchor.train_eval(g, P=1, rate=1.0, epochs=20, device="cpu",
                            work=str(tmp_path))
    assert 1.0 / kw["n_class"] < acc <= 1.0


@pytest.mark.slow
def test_calibrated_anchor_through_quantized_stack_on_cpu(tmp_path):
    """The JAX package's gate, in the port: exact (P=1, rate 1.0, f32,
    ELL) plateaus inside the band, and the TPU recipe's stack (P=4, rate
    0.1, hybrid, int8 dense tiles, int8 gathers, int8 halo wire) lands
    within 0.005 of it."""
    g = anchor.anchor_graph()
    exact = anchor.train_eval(g, P=1, rate=1.0, epochs=anchor.EPOCHS,
                              device="cpu", work=str(tmp_path / "e"))
    quant = anchor.train_eval(g, P=4, rate=0.1, epochs=anchor.EPOCHS,
                              spmm="hybrid", use_pallas=True,
                              spmm_gather="int8", spmm_dense="int8",
                              halo_wire="int8", device="cpu",
                              work=str(tmp_path / "q"))
    assert anchor.EXACT_BAND[0] < exact < anchor.EXACT_BAND[1], exact
    assert abs(quant - exact) <= anchor.QUANT_TOL, (quant, exact)


@pytest.mark.slow
def test_mutation_biased_sampler_trips_accuracy_gate_on_cpu(tmp_path):
    """The JAX package's mutation gate, in the port: a first-k "sample" of
    every boundary list, applied by each rank to itself, craters the
    accuracy far past the 0.005 band (the JAX package measured 96.6% ->
    47%)."""
    g = anchor.anchor_graph()
    exact = anchor.train_eval(g, P=1, rate=1.0, epochs=anchor.EPOCHS,
                              device="cpu", work=str(tmp_path / "e"))
    biased = anchor.train_eval(g, P=4, rate=0.1, epochs=anchor.EPOCHS,
                               device="cpu", work=str(tmp_path / "b"),
                               biased_sampler=True)
    assert biased < exact - 0.05, (biased, exact)

"""bnsgcn_tpu_torch/k1_ab.py off the card: it refuses to measure without a
GPU, and hands K1 each row kind as the main paths do (the comparison
itself runs on the card)."""

import torch

from bnsgcn_tpu_torch import k1_ab


def test_k1_ab_needs_the_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k1_ab.main(["other.cu"]) == 2
    assert "needs the GPU" in capsys.readouterr().err


def test_k1_ab_row_kinds_are_the_main_paths():
    h = torch.randn(5, 16, generator=torch.Generator().manual_seed(0))
    want = {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8, "fp8": torch.float8_e4m3fn}
    assert set(k1_ab.KINDS) == set(want)
    for kind, dtype in want.items():
        rows, kw = k1_ab.as_rows(h, kind)
        assert rows.dtype == dtype and rows.shape == h.shape
        if kind in ("f32", "bf16"):
            assert kw == {}
        else:
            assert kw["out_dtype"] == torch.bfloat16
            assert kw["scale"].dtype == torch.float32

"""The plain reference against dense products."""

import torch

from spmv_bench import reference


def _case(n=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(n, n, generator=g, dtype=torch.float64)
    a[torch.rand(n, n, generator=g) < 0.8] = 0
    a[5] = 0                                          # an empty row
    rows, cols = a.nonzero(as_tuple=True)
    return a, reference.Coo(n, rows, cols, a[rows, cols])


def test_matvec_is_the_dense_product(monkeypatch):
    monkeypatch.setattr(reference, "BLOCK", 7)        # several blocks
    a, coo = _case()
    x = torch.randn(40, dtype=torch.float64)
    y = torch.randn(40, dtype=torch.float64)
    assert torch.allclose(coo.matvec(x, y), a @ x + y, rtol=0, atol=1e-13)
    assert torch.allclose(coo.matvec(x, None, absolute=True),
                          a.abs() @ x.abs(), rtol=0, atol=1e-13)


def test_float32_reference():
    a, coo = _case()
    coo32 = reference.Coo(coo.n, coo.rows, coo.cols, coo.values,
                          torch.float32)
    x = torch.randn(40, dtype=torch.float64)
    out = coo32.matvec(x)
    assert out.dtype == torch.float32
    assert torch.allclose(out.double(), a @ x, rtol=0, atol=1e-5)


def test_chained_is_the_dense_recursion():
    a, coo = _case()
    x = torch.rand(40, dtype=torch.float64)
    y = torch.zeros(40, dtype=torch.float64)
    got, size = reference.chained(coo, x, y, 5, 1e-3)
    want, xs = y, x
    for _ in range(5):
        want = a @ xs + want
        xs = want * 1e-3
    assert bool(((got - want).abs() <= 1e-14 * size).all())
    assert bool((size >= got.abs() - 1e-15).all())
    assert float(size[5]) == 0.0


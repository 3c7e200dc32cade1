"""The device generators, run on the CPU at small sizes: the FEM mesh
against the class of its NumPy original in
``ellspmv_tpu_torch/models/generators.py``, the Kronecker graph against
the Graph500 specification's construction."""

import pytest
import torch

from spmv_bench.generators import fem_mesh_2d, kronecker

FEM = {"nx": 64, "extras": 5, "diagonal": 24.0}
KRON = {"scale": 12, "edgefactor": 16, "a": 0.57, "b": 0.19, "c": 0.19}
# the NumPy original at this size, seeds 0-2: fem_mesh_2d(64, extras=5)
NUMPY_FEM_NNZ = (66448, 66440, 66726)


def _dense(m):
    a = torch.zeros(m.num_rows, m.num_rows, dtype=torch.float64)
    a[m.rows, m.cols] = m.values
    return a


@pytest.mark.parametrize("seed", [0, 1, 2**40 + 3])
def test_fem_mesh_is_the_numpy_class(seed):
    m = fem_mesh_2d.generate(FEM, seed, "cpu")
    assert m.num_rows == 64 * 64
    lo, hi = min(NUMPY_FEM_NNZ), max(NUMPY_FEM_NNZ)
    assert 0.99 * lo <= m.num_nonzeros <= 1.01 * hi
    key = m.rows * m.num_rows + m.cols
    assert bool((key[1:] > key[:-1]).all())            # sorted, no duplicates
    assert m.distinct_values == (m.num_nonzeros + m.num_rows) // 2
    assert m.referenced_columns == m.num_rows
    offsets = torch.unique((m.cols - m.rows))
    assert offsets.numel() <= 25                      # the 5x5 stencil
    a = _dense(m)
    assert torch.equal(a, a.T)
    assert float(torch.linalg.eigvalsh(a).min()) > 0  # SPD


def test_fem_mesh_follows_the_seed():
    a = fem_mesh_2d.generate(FEM, 5, "cpu")
    b = fem_mesh_2d.generate(FEM, 5, "cpu")
    c = fem_mesh_2d.generate(FEM, 6, "cpu")
    assert torch.equal(a.cols, b.cols) and torch.equal(a.values, b.values)
    assert not torch.equal(a.values[:100], c.values[:100])


def _edges(params, seed):
    """The specification's edge list, drawn as the generator draws it,
    before the label permutation."""
    g = torch.Generator().manual_seed(seed)
    n, m = 1 << params["scale"], params["edgefactor"] << params["scale"]
    a, b, c = params["a"], params["b"], params["c"]
    i = torch.zeros(m, dtype=torch.int64)
    j = torch.zeros(m, dtype=torch.int64)
    for bit in range(params["scale"]):
        ib = torch.rand(m, generator=g, dtype=torch.float64) > a + b
        jb = torch.rand(m, generator=g, dtype=torch.float64) > torch.where(
            ib, c / (1 - a - b), a / (a + b))
        i |= ib.long() << bit
        j |= jb.long() << bit
    return n, i, j, g


@pytest.mark.parametrize("seed", [0, 1, 2**40 + 3])
def test_kronecker_is_the_specifications_graph(seed):
    m = kronecker.generate(KRON, seed, "cpu")
    n, i, j, g = _edges(KRON, seed)
    label = torch.randperm(n, generator=g)
    i, j = label[i], label[j]
    keep = i != j
    pairs = torch.unique(torch.minimum(i, j)[keep] * n
                         + torch.maximum(i, j)[keep])
    assert m.num_rows == n
    assert m.distinct_values == pairs.numel()
    assert m.num_nonzeros == 2 * pairs.numel()
    key = m.rows * n + m.cols
    assert bool((key[1:] > key[:-1]).all())            # sorted, no duplicates
    assert not bool((m.rows == m.cols).any())          # no self-loops
    a = torch.zeros(n, n, dtype=torch.float64)
    a[m.rows, m.cols] = m.values
    assert torch.equal(a, a.T)
    assert torch.equal(torch.unique(torch.minimum(m.rows, m.cols) * n
                                    + torch.maximum(m.rows, m.cols)), pairs)
    assert float(m.values.min()) >= 0 and float(m.values.max()) < 1
    deg = torch.bincount(m.rows, minlength=n)
    assert m.referenced_columns == int((deg > 0).sum()) < n   # empty rows
    assert int(deg.max()) > 50 * m.num_nonzeros / n            # hubs


def test_kronecker_initiator():
    """The first level's quadrants come out in A, B, C, D's shares."""
    n, i, j, _ = _edges({**KRON, "scale": 1, "edgefactor": 400000}, 7)
    share = torch.bincount(2 * i + j, minlength=4).double() / i.numel()
    want = torch.tensor([0.57, 0.19, 0.19, 0.05], dtype=torch.float64)
    assert torch.allclose(share, want, atol=3e-3)


def test_kronecker_follows_the_seed():
    a = kronecker.generate(KRON, 5, "cpu")
    b = kronecker.generate(KRON, 5, "cpu")
    c = kronecker.generate(KRON, 6, "cpu")
    assert torch.equal(a.cols, b.cols) and torch.equal(a.values, b.values)
    assert not torch.equal(a.cols[:100], c.cols[:100])

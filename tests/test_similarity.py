"""Similarity measure tests: pair goldens vs direct formulas + pairwise
consistency. (The reference module is an orphan with zero tests; these
encode its exact semantics, quirks included.)"""

import numpy as np
import pytest

from single_algebra_tpu.similarity import (
    CosineSimilarity,
    EuclideanSimilarity,
    JaccardSimilarity,
    ManhattanSimilarity,
    PearsonSimilarity,
)


@pytest.fixture
def vecs():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(40)
    b = rng.standard_normal(40)
    return a, b


def test_cosine(vecs):
    a, b = vecs
    expected = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert np.isclose(CosineSimilarity().calculate(a, b), expected, rtol=1e-10)
    # zero-norm guard -> 0.0 (similarity/mod.rs:30-34)
    assert CosineSimilarity().calculate(np.zeros(4), b[:4]) == 0.0


def test_euclidean(vecs):
    a, b = vecs
    expected = np.exp(-1.0 * np.linalg.norm(a - b))
    assert np.isclose(EuclideanSimilarity().calculate(a, b), expected, rtol=1e-8)
    expected2 = np.exp(-0.3 * np.linalg.norm(a - b))
    assert np.isclose(
        EuclideanSimilarity(gamma=0.3).calculate(a, b), expected2, rtol=1e-8
    )


def test_pearson(vecs):
    a, b = vecs
    expected = np.corrcoef(a, b)[0, 1]
    assert np.isclose(PearsonSimilarity().calculate(a, b), expected, rtol=1e-10)
    # constant vector -> zero denominator -> 0.0
    assert PearsonSimilarity().calculate(np.ones(10), b[:10]) == 0.0


def test_manhattan(vecs):
    a, b = vecs
    expected = np.exp(-1.0 * np.abs(a - b).sum())
    assert np.isclose(
        ManhattanSimilarity().calculate(a, b), expected, rtol=1e-8
    )


def test_jaccard_quirks():
    # intersection counts near-equal positions INCLUDING both-zero pairs;
    # union counts only positive positions (reference semantics)
    a = np.array([1.0, 0.0, 0.0, 2.0])
    b = np.array([1.0, 0.0, 3.0, 0.0])
    # |a-b|<eps at positions 0,1 -> intersection=2; union: pos 0,2,3 -> 3
    sim = JaccardSimilarity().calculate(a, b)
    assert np.isclose(sim, 2.0 / 3.0)
    # all-zero pair: union=0 -> 0.0
    assert JaccardSimilarity().calculate(np.zeros(3), np.zeros(3)) == 0.0
    # threshold parameter
    sim2 = JaccardSimilarity(threshold=1.5).calculate(a, b)
    # |a-b| = [0,0,3,2] < 1.5 at 2 positions; union 3
    assert np.isclose(sim2, 2.0 / 3.0)


@pytest.mark.parametrize(
    "measure",
    [
        CosineSimilarity(),
        EuclideanSimilarity(0.5),
        PearsonSimilarity(),
        ManhattanSimilarity(2.0),
        JaccardSimilarity(0.1),
    ],
)
def test_pairwise_matches_calculate(measure):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((7, 12))
    X[X < 0] = 0.0  # include zeros for jaccard unions
    Y = rng.standard_normal((5, 12))
    Y[Y < 0] = 0.0
    P = np.asarray(measure.pairwise(X, Y))
    assert P.shape == (7, 5)
    for i in range(7):
        for j in range(5):
            assert np.isclose(
                P[i, j], measure.calculate(X[i], Y[j]), rtol=1e-7, atol=1e-9
            ), (i, j)


def test_pairwise_self():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((20, 8))
    P = np.asarray(CosineSimilarity().pairwise(X))
    assert P.shape == (20, 20)
    np.testing.assert_allclose(np.diag(P), 1.0, rtol=1e-6)
    np.testing.assert_allclose(P, P.T, rtol=1e-10)


def test_pairwise_blocked_large():
    # forces multiple row blocks through the blocked elementwise path
    rng = np.random.default_rng(3)
    X = rng.standard_normal((600, 64))
    Y = rng.standard_normal((300, 64))
    P = np.asarray(ManhattanSimilarity(0.1).pairwise(X, Y))
    d = np.abs(X[:, None, :] - Y[None, :, :]).sum(-1)
    np.testing.assert_allclose(P, np.exp(-0.1 * d), rtol=1e-6)

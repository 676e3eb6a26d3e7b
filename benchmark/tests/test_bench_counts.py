"""The count functions against counts made by hand at tiny shapes."""
import pytest

from benchmark.counts.paths import path_ops, step_ops
from benchmark.counts.peaks import bound_ms
from benchmark.counts.rollout import bwd_ops, fwd_ops, operand_elems, rollout_bound_ms

# cartpole's widths (D 4, one active dim, U 1) at S 2, B 3, M 2, Mp 2, T 1
N = dict(S=2, B=3, D=4, U=1, De=5, Dxu=6, L=1, M=2, Lp=1, Mp=2, T=1)


def test_operand_elems_by_hand():
    # x0 8, zp 10, zp2 2, alpha 2, ilp 5, wp 1, mc_p 1, omega 18, phase 3, ild 6,
    # zd 12, zd2 2, w 6, v 4, wd 4, mc_d 4, target 5, precis 25
    assert operand_elems(N) == 118


def test_rollout_ops_by_hand():
    # forward per (particle, step): policy 2 * (2 * 5 + 8) = 36, bases 3 * (2 * 6 + 4) = 48,
    # centers 2 * (2 * 6 + 8) = 40, encoder/Euler/cost 2 * 4 * 1 + 4 * 25 + 40 = 148
    assert fwd_ops(N) == 2 * (36 + 48 + 40 + 148)
    # backward: policy 2 * (6 * 5 + 14) = 88, bases 3 * 28 = 84, centers 2 * 32 = 64, 2 * 148
    assert bwd_ops(N) == 2 * (88 + 84 + 64 + 296)


def test_rollout_bound_by_hand():
    # forward: bytes (118 + 2 + 2 * 2 * 4) * 4 = 544 over 3.35e12 B/s is 1.624e-10 s;
    # operations 544 over 67e12 is 8.1e-12 s: bytes bound it
    ms, which = rollout_bound_ms("fwd", N, "float32")
    assert which == "bytes" and ms == pytest.approx(1e3 * 544 / 3.35e12)
    # backward in float64: inputs 118 + 2 (gl) + 1 * 2 * 4 - 8, outputs 10 + 2 + 5
    ms, which = rollout_bound_ms("bwd", N, "float64")
    assert which == "bytes" and ms == pytest.approx(1e3 * (120 + 17) * 8 / 3.35e12)


def test_bound_picks_the_larger():
    assert bound_ms(0, 67e12, "float32") == (1e3, "operations")
    assert bound_ms(3.35e12, 0, "float64") == (1e3, "bytes")
    assert bound_ms(0, 34e12, "float64")[0] == pytest.approx(1e3)


def test_path_ops_by_hand():
    # samples 2 * S L M (M + 1) = 24; prior L M B (2 Dxu + 2) = 84 and 2 S L M B = 24;
    # Kuu 4 * (3 * 6 + 2) = 80, its factor 8 // 3 = 2, the solves 2 * S L M^2 = 16
    assert path_ops(N) == 24 + 84 + 24 + 80 + 2 + 16
    assert step_ops(N) == path_ops(N) + fwd_ops(N) + bwd_ops(N)

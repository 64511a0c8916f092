"""The roofline count of ``assign.roofline`` on hand-counted shapes,
and its reader on a made-up trace."""

import pytest

from msmbench.harness import spec
from msmbench.harness.trace import Event, Span, Trace


def test_counts_by_hand():
    roof = spec.roofline('assign.roofline')
    # 1,000 frames x 10 centers of 4 atoms: 10,000 pairs
    cross, epi, nbytes = roof.counts(1000, 10, 4)
    assert cross == 18 * 4 * 10_000          # 720,000
    assert epi == 95 * 10_000                # 950,000
    assert nbytes == 12 * 4 * 1010 + 8 * 1000   # 56,480


@pytest.mark.parametrize('n,k,A,bound', [
    # the cross-covariance bounds a wide job: 18 * 80 * 3.215e9 flops
    (3_215_000, 1000, 80, 18 * 80 * 3.215e9 / 495e12),
    # one center: the bytes bound (12 * 80 * 3,215,001 + 8 * 3,215,000)
    (3_215_000, 1, 80, (12 * 80 * 3_215_001 + 8 * 3_215_000) / 3.35e12),
    # few atoms, many centers: the float32 epilogue bounds
    (100_000, 10_000, 1, 95 * 1e9 / 67e12),
])
def test_least_time_takes_the_largest_bound(n, k, A, bound):
    roof = spec.roofline('assign.roofline')
    assert roof.least_seconds(n, k, A) == pytest.approx(bound, rel=1e-12)


def test_reader_share_of_kernel_time():
    cfg = {'n_frames': 3_215_000, 'n_atoms': 80,
           'cluster': {'n_clusters': 1000}}
    least = spec.roofline('assign.roofline').least_seconds(3_215_000, 1000,
                                                           80)
    # two jobs, kernel 5 takes 0.1 s a job in two launches; another
    # kernel and a launch outside the span do not count
    spans = [Span('job', 0, 1e6, 1.0), Span('assign', 1e5, 5e5, 0.4),
             Span('job', 1e6, 2e6, 1.0), Span('assign', 1.1e6, 1.5e6, 0.4)]
    gpu = [Event('void qcp_matrix_kernel(float const*)', 1.2e5, 1.7e5),
           Event('void qcp_matrix_kernel(float const*)', 2e5, 2.5e5),
           Event('void qcp_matrix_kernel(float const*)', 1.2e6, 1.3e6),
           Event('elementwise_kernel', 1.35e6, 1.4e6),
           Event('void qcp_matrix_kernel(float const*)', 1.6e6, 1.7e6)]
    tr = Trace([], gpu, spans, cfg, {})
    share = spec.metric_reader('assign.roofline').read(tr)
    assert share == pytest.approx(100 * least / 0.1)
    assert spec.metric_reader('assign.roofline').read(
        Trace([], [], spans, cfg, {})) is None

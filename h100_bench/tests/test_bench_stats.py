"""The end-to-end statistics take the whole window and every request, so
a stall moves them."""
import numpy as np

from h100_bench import stats


def _fake_run(stalls=(), stall_s=0.0):
    """Requests due every 0.1 s over [0, 10); each gets its first token
    0.2 s after its due time and 40 more every 0.05 s; at each time in
    ``stalls`` the server stops for ``stall_s``, pushing back every later
    stamp."""
    due, tokens = [], []
    for i in range(100):
        d = 0.1 * i
        t = d + 0.2 + 0.05 * np.arange(41)
        for at in stalls:
            t = np.where(t >= at, t + stall_s, t)
        due.append(d)
        tokens.append(t.tolist())
    return due, tokens


def _metrics(due, tokens, w0=0.0, w1=10.0):
    first = [t[0] if t else None for t in tokens]
    return (stats.output_tokens_per_s(tokens, w0, w1),
            stats.p95(stats.ttft_values(due, first, w0, w1)),
            stats.p95(stats.itl_values(tokens, w0, w1)))


def test_steady_run():
    rate, ttft, itl = _metrics(*_fake_run())
    assert abs(ttft - 0.2) < 1e-9 and abs(itl - 0.05) < 1e-9
    assert 350 < rate < 420


def test_a_stall_moves_rate_and_both_tails():
    rate, ttft, itl = _metrics(*_fake_run())
    # the server stops for 0.3 s every second from t = 3
    s_rate, s_ttft, s_itl = _metrics(*_fake_run(np.arange(3.0, 10.0), 0.3))
    assert s_rate < rate * 0.9
    assert s_ttft > ttft + 0.5
    # a tenth of the gaps straddle a stall: the 95th percentile is one
    assert s_itl > 0.3


def test_requests_without_a_token_count_their_wait():
    due = [1.0, 2.0, 9.0]
    first = [1.1, None, 12.0]          # none, and one after the window
    v = stats.ttft_values(due, first, 0.0, 10.0)
    assert np.allclose(v, [0.1, 8.0, 1.0])


def test_only_the_window_counts():
    tokens = [[-1.0, 0.5, 9.5, 10.5]]
    assert stats.output_tokens_per_s(tokens, 0.0, 10.0) == 0.2
    assert stats.itl_values(tokens, 0.0, 10.0) == [1.5, 9.0]

"""The port's Prefetcher (mvgformer_tpu_torch/data/prefetch.py): order,
early close, producer exceptions re-raised, the wait counters, and the
DevicePlacer that puts Batches on a device. Template:
tests/test_prefetch.py. The card test (marked gpu, skipped without a card)
holds the placed batches of the copy stream against synchronous copies;
this file imports no JAX, so the card's machine runs it with
`-m gpu --noconftest`."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from mvgformer_tpu_torch.config import load_config
from mvgformer_tpu_torch.data.meta import map_tensors
from mvgformer_tpu_torch.data.prefetch import DevicePlacer, Prefetcher
from mvgformer_tpu_torch.data.synthetic import make_batch


def test_yields_all_in_order_with_place_fn():
    items = [(i, i * 10) for i in range(5)]
    pf = Prefetcher(iter(items), place_fn=lambda x: x + 1, depth=2)
    assert list(pf) == [(i, i * 10 + 1) for i in range(5)]
    assert pf.total_wait_s >= pf.last_wait_s >= 0.0


def test_ready_fn_runs_on_the_consumer_thread():
    producer = []

    def place(x):
        producer.append(threading.get_ident())
        return x * 2

    consumer = []

    def ready(x):
        consumer.append(threading.get_ident())
        return x + 1

    got = list(Prefetcher(iter([(i, i) for i in range(4)]), place,
                          ready_fn=ready))
    assert got == [(i, 2 * i + 1) for i in range(4)]
    assert set(consumer) == {threading.get_ident()}
    assert threading.get_ident() not in producer


def test_propagates_producer_errors():
    def gen():
        yield 0, 1
        raise RuntimeError("boom")

    pf = Prefetcher(gen(), place_fn=lambda x: x)
    with pytest.raises(RuntimeError, match="boom"):
        list(pf)


def test_propagates_place_fn_errors():
    def place(x):
        if x == 2:
            raise ValueError("bad batch")
        return x

    pf = Prefetcher(iter([(i, i) for i in range(4)]), place)
    got = []
    with pytest.raises(ValueError, match="bad batch"):
        for item in pf:
            got.append(item)
    assert got == [(0, 0), (1, 1)]


def test_empty_iterator():
    assert list(Prefetcher(iter([]), place_fn=lambda x: x)) == []


def test_sentinel_survives_full_queue():
    pf = Prefetcher(iter([(i, i) for i in range(6)]), place_fn=lambda b: b,
                    depth=1)
    time.sleep(0.3)  # the producer fills the queue and finishes
    assert [idx for idx, _ in pf] == [0, 1, 2, 3, 4, 5]


def test_early_break_joins_producer():
    def gen():
        for i in range(100):
            yield i, i

    pf = Prefetcher(gen(), place_fn=lambda b: b, depth=2)
    for idx, _ in pf:
        if idx >= 1:
            break
    pf.close()
    assert not pf._thread.is_alive()


def test_close_by_context_manager_stops_a_blocked_producer():
    with Prefetcher(iter([(i, i) for i in range(100)]),
                    place_fn=lambda b: b, depth=1) as pf:
        time.sleep(0.2)  # the producer blocks on the full queue
    assert not pf._thread.is_alive()


def test_wait_counters_measure_a_slow_producer():
    def slow(x):
        time.sleep(0.05)
        return x

    pf = Prefetcher(iter([(i, i) for i in range(4)]), slow, depth=1)
    waits = []
    for _ in pf:
        waits.append(pf.last_wait_s)
    assert len(waits) == 4
    assert min(waits) > 0.02
    assert pf.total_wait_s >= sum(waits) - 1e-9


def test_stress_many_prefetchers_under_fast_thread_switching():
    """16 Prefetchers, each drained by its own consumer thread (32 threads
    on fewer cores), with the interpreter switching threads every
    microsecond: every consumer gets all its items, in order."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        n, results = 500, {}

        def consume(k):
            pf = Prefetcher(iter([(i, i) for i in range(n)]),
                            place_fn=lambda x: x * k, depth=1 + k % 3)
            results[k] = list(pf)

        threads = [threading.Thread(target=consume, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(results) == list(range(16))
    for k, got in results.items():
        assert got == [(i, i * k) for i in range(n)]


def _toy_cfg():
    cfg = load_config()
    cfg.NETWORK.IMAGE_SIZE = [96, 64]
    cfg.DATASET.CAMERA_NUM = 3
    cfg.MULTI_PERSON.MAX_PEOPLE_NUM = 4
    return cfg


def _frames(n):
    cfg = _toy_cfg()
    return [(i, make_batch(cfg, seed=i, device="cpu")) for i in range(n)]


def _assert_batches_equal(got, want):
    flat_got, flat_want = [], []
    map_tensors(got, flat_got.append)
    map_tensors(want, flat_want.append)
    assert len(flat_got) == len(flat_want) > 10
    for g, w in zip(flat_got, flat_want):
        assert g.device == w.device and g.dtype == w.dtype
        assert torch.equal(g, w)


def test_device_placer_on_the_cpu():
    frames = _frames(3)
    got = list(DevicePlacer("cpu").prefetch(iter(frames)))
    assert [i for i, _ in got] == [0, 1, 2]
    for (_, g), (_, w) in zip(got, frames):
        _assert_batches_equal(g, w)


@pytest.mark.gpu
def test_device_placer_on_the_card_equals_a_synchronous_copy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    frames = _frames(6)
    placer = DevicePlacer("cuda")
    for i, batch in placer.prefetch(iter(frames), depth=2):
        # keep the consumer's stream busy so a copy not waited for would
        # be read early
        x = torch.randn(2048, 2048, device="cuda")
        for _ in range(20):
            x = x @ x / 2048.0
        _assert_batches_equal(batch, frames[i][1].to("cuda"))
        assert np.isfinite(x.sum().item())

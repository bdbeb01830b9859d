"""The traffic generator: the same seed gives the same requests; every seed
asks for the same multiset of work in a cycle, in another order."""

import collections

import numpy as np

from portbench import config, traffic_gen


def test_same_seed_same_requests():
    mix = config.traffic("mixed-closed4")
    pool_a = traffic_gen.FramePool(2**31 + 7, 56, 4)
    pool_b = traffic_gen.FramePool(2**31 + 7, 56, 4)
    assert np.array_equal(pool_a.images, pool_b.images)
    for i, item in enumerate(traffic_gen.plan(mix, 2**31 + 7, 0)[:6]):
        a = traffic_gen.request(pool_a, item, 2**31 + 7, i)
        b = traffic_gen.request(pool_b, item, 2**31 + 7, i)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_every_seed_asks_for_the_same_work():
    mix = config.traffic("mixed-closed4")

    def work(seed):
        return collections.Counter((r["views"], r["camera"], r["depth"])
                                   for r in traffic_gen.plan(mix, seed, 0))

    sizes = collections.Counter(r["views"] for r in traffic_gen.plan(mix, 1, 0))
    assert sum(sizes.values()) == mix["cycle"]
    assert sum(v * c for v, c in sizes.items()) == 407  # 1/S over 2..16: a mean of 6.36 views
    # the views and the layouts are each fixed; their pairing follows the order
    for seed in (2, 3, 2**31 + 11):
        plan = traffic_gen.plan(mix, seed, 0)
        assert collections.Counter(r["views"] for r in plan) == sizes
        assert (collections.Counter(r["camera"] + r["depth"] for r in plan)
                == collections.Counter(r["camera"] + r["depth"]
                                       for r in traffic_gen.plan(mix, 1, 0)))
    assert [r["views"] for r in traffic_gen.plan(mix, 1, 0)] != \
        [r["views"] for r in traffic_gen.plan(mix, 2, 0)]
    assert work(5) == work(5)


def test_exact_counts():
    assert traffic_gen.exact_counts({2: 1.0, 3: 1.0, 4: 2.0}, 8) == {2: 2, 3: 2, 4: 4}
    assert sum(traffic_gen.exact_counts({s: 1 / s for s in range(2, 17)}, 64).values()) == 64


def test_the_order_is_balanced():
    """Any run of consecutive requests holds each size within 2 of its
    share, so a window ending inside a cycle still served the mix."""
    mix = config.traffic("mixed-closed4")
    counts = collections.Counter(r["views"] for r in traffic_gen.plan(mix, 9, 0))
    plan = traffic_gen.plan(mix, 9, 0)
    for m in (16, 32, 46, 64):
        got = collections.Counter(r["views"] for r in plan[:m])
        for views, c in counts.items():
            assert abs(got[views] - c * m / mix["cycle"]) <= 2, (m, views)

"""The port's fabric model (``repro_torch.fabric``) against the JAX
package's on the CPU, exactly: both are the same numpy, so every route on
an 8 x 8 torus (healthy and degraded by a seeded ``degrade_links``), each
ring all-reduce's bandwidth and link loads, and Fig. 12's summaries for
seeds 0..4 must be equal, not close.
"""
import numpy as np
import pytest

from repro.fabric import routing as r_routing
from repro.fabric import simulate as r_simulate
from repro.fabric import topology as r_topology
from repro_torch.fabric import routing as t_routing
from repro_torch.fabric import simulate as t_simulate
from repro_torch.fabric import topology as t_topology

SEEDS = range(5)


def links(t):
    return {k: (l.a, l.b, l.capacity, l.degradation, l.down) for k, l in t.links.items()}


def tori(seed):
    """The same 8 x 8 torus in both packages with the links each degraded
    (Fig. 12a's storm, from ``seed``; none for a seed of None)."""
    out = []
    for topo in (r_topology, t_topology):
        t = topo.Torus2D(8, 8)
        down = [] if seed is None else t.degrade_links(0.08, 0.9, np.random.default_rng(seed))
        out.append((t, down))
    return out


def test_topology_constants_and_shape():
    assert t_topology.LINK_BW == r_topology.LINK_BW
    (r, _), (t, _) = tori(None)
    assert links(t) == links(r) and len(t.links) == 128 and t.n_nodes == 64
    for i in range(64):
        assert t.coords(i) == r.coords(i) and t.neighbors(i) == r.neighbors(i)
    for x in range(-3, 11):
        for y in range(-3, 11):
            assert t.nid(x, y) == r.nid(x, y)


@pytest.mark.parametrize("seed", [None, 0, 3])
def test_every_route_equal(seed):
    """Static and adaptive routes for every (src, dst), with and without a
    link load, on a healthy torus and on two degraded ones."""
    (r, r_down), (t, t_down) = tori(seed)
    assert t_down == r_down and links(t) == links(r)
    if seed is not None:
        assert any(l.degradation > 0 for l in t.links.values())
    load = {k: i % 3 for i, k in enumerate(sorted(t.links))}
    for src in range(64):
        for dst in range(64):
            assert (t_routing.static_route(t, src, dst)
                    == r_routing.static_route(r, src, dst))
            for x_first in (True, False):
                assert (t_routing._dor_path(t, src, dst, x_first)
                        == r_routing._dor_path(r, src, dst, x_first))
            assert (t_routing.adaptive_route(t, src, dst)
                    == r_routing.adaptive_route(r, src, dst))
            assert (t_routing.adaptive_route(t, src, dst, dict(load))
                    == r_routing.adaptive_route(r, src, dst, dict(load)))


def test_adaptive_route_avoids_a_down_link_as_the_reference():
    r, t = r_topology.Torus2D(4, 4), t_topology.Torus2D(4, 4)
    for topo, routing in ((r, r_routing), (t, t_routing)):
        for a, b in routing.static_route(topo, topo.nid(0, 0), topo.nid(2, 0)):
            topo.link(a, b).down = True
    want = r_routing.adaptive_route(r, r.nid(0, 0), r.nid(2, 0))
    got = t_routing.adaptive_route(t, t.nid(0, 0), t.nid(2, 0))
    assert got == want and all(not t.link(a, b).down for a, b in got)


@pytest.mark.parametrize("seed", SEEDS)
def test_ring_allreduce_bandwidth_and_load_equal(seed):
    (r, _), (t, _) = tori(seed)
    members = np.random.default_rng(100 + seed).permutation(64).tolist()
    for rr, tr in ((r_routing.static_route, t_routing.static_route),
                   (r_routing.adaptive_route, t_routing.adaptive_route)):
        want_bw, want_load = r_routing.ring_allreduce_bandwidth(r, members, rr)
        got_bw, got_load = t_routing.ring_allreduce_bandwidth(t, members, tr)
        assert got_bw == want_bw and got_load == want_load
        # a second ring on top of the first one's load, at a payload factor
        kw = dict(payload_factor=0.5)
        want = r_routing.ring_allreduce_bandwidth(r, members[:16], rr,
                                                  existing_load=want_load, **kw)
        got = t_routing.ring_allreduce_bandwidth(t, members[:16], tr,
                                                 existing_load=got_load, **kw)
        assert got == want
    # a ring of one member moves nothing, as the reference's
    assert (t_routing.ring_allreduce_bandwidth(t, [5])
            == r_routing.ring_allreduce_bandwidth(r, [5]))


@pytest.mark.parametrize("seed", SEEDS)
def test_fig12_summaries_equal(seed):
    want = r_simulate.link_error_experiment(seed=seed)
    got = t_simulate.link_error_experiment(seed=seed)
    assert got.static_bw == want.static_bw and got.adaptive_bw == want.adaptive_bw
    assert got.summary() == want.summary()
    want = r_simulate.contention_experiment(seed=seed)
    got = t_simulate.contention_experiment(seed=seed)
    assert got.static_bw == want.static_bw and got.adaptive_bw == want.adaptive_bw
    assert got.summary() == want.summary()


def test_fig12_conclusions_hold_on_the_port():
    a = t_simulate.link_error_experiment(seed=0).summary()
    assert a["adaptive_mean"] > 1.5 * a["static_mean"]
    b = t_simulate.contention_experiment(seed=1).summary()
    assert b["adaptive_mean"] >= 0.95 * b["static_mean"]
    assert b["adaptive_std"] <= 1.1 * b["static_std"]


@pytest.mark.parametrize("frac,degradation", [(0.2, 0.9), (0.05, 0.5), (0.0, 0.3)])
def test_degrade_and_heal_equal(frac, degradation):
    r, t = r_topology.Torus2D(4, 4), t_topology.Torus2D(4, 4)
    want = r.degrade_links(frac, degradation, np.random.default_rng(7))
    got = t.degrade_links(frac, degradation, np.random.default_rng(7))
    assert got == want and links(t) == links(r)
    assert ([l.effective_capacity for l in t.links.values()]
            == [l.effective_capacity for l in r.links.values()])
    t.link(*got[0]).down = True
    assert t.link(*got[0]).effective_capacity == 0.0
    t.heal()
    r.heal()
    assert links(t) == links(r)
    assert all(l.degradation == 0 and not l.down for l in t.links.values())

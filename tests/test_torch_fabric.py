"""The port's fabric probe (``workloads/fabric.py``) against the JAX
package's ``tpu_operator.workloads.fabric``.

The pure functions are held to the reference on every parametrised
input: the edge enumeration (wrap edges too) over many block shapes,
``edge_key``, ``gang_fabric_artifact`` (an overhang included) and the
copies of the torus helpers (``parse_topology``, ``parse_shape``,
``worker_coords``). One 4-rank gloo world runs the live probe on
"2x2x1" and on "4x1x1" with wrap, whose edge keys, axes and report keys
must equal the reference probe's on 4 virtual CPU devices, and the
reference's errors for a bad shape and a short world.
"""

import functools
import itertools

import pytest

from tpu_operator.nodeinfo import parse_topology as ref_parse_topology
from tpu_operator.placement import torus as ref_torus
from tpu_operator.workloads import fabric as rf
from tpu_operator_torch.workloads import fabric as tf
from tpu_operator_torch.workloads.distributed import spawn_world

N = 4
SHAPES = [(1, 1, 1), (2, 1, 1), (4, 1, 1), (2, 2, 1), (2, 4, 1), (3, 3, 1), (2, 2, 2),
          (4, 4, 4), (1, 5, 3), (3, 1, 4), (8, 2, 1)]
TOPOLOGIES = ["4x4x4", "2x4", "16", "2X2", "0x4", "-1x2", "axb", "", "4x4x4x4", "1x1x1", "2x"]
LIVE = {"2x2x1": False, "4x1x1": True}  # shape: wrap


@pytest.mark.parametrize("wrap", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_block_edges_match_the_reference(shape, wrap):
    assert tf.enumerate_block_edges(shape, wrap=wrap) == rf.enumerate_block_edges(shape, wrap=wrap)


@pytest.mark.parametrize("topology", TOPOLOGIES)
def test_torus_copies_match_the_reference(topology):
    assert tf.parse_topology(topology) == ref_parse_topology(topology)
    assert tf.parse_shape(topology) == ref_torus.parse_shape(topology)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_worker_coords_match_the_reference(shape):
    n = shape[0] * shape[1] * shape[2]
    got = [tf.worker_coords(i, shape) for i in range(n)]
    assert got == [ref_torus.worker_coords(i, shape) for i in range(n)]
    assert [tf._rank_at(c, shape) for c in got] == list(range(n))


@pytest.mark.parametrize("a, b", itertools.combinations(["n0", "n1", "0-0-0", "1-0-0", ""], 2))
def test_edge_key_matches_the_reference(a, b):
    assert tf.edge_key(a, b) == tf.edge_key(b, a) == rf.edge_key(a, b)


def _synthetic_probe(shape, wrap):
    dims = rf.parse_shape(shape)
    edges = {}
    for i, (at, to, axis, is_wrap) in enumerate(rf.enumerate_block_edges(dims, wrap=wrap)):
        edges[rf.edge_key(rf._coord_str(at), rf._coord_str(to))] = {
            "bw_gbps": float((7 * i) % 11 + 1), "axis": axis, "wrap": is_wrap}
    return {"shape": shape, "edges": edges, "axis_allreduce_us": {"x": 11.0}}


# (probe shape, wrap, hosts): the last two carry an overhang (a probe
# larger than the gang) and no edges at all
ARTIFACTS = [("2x2x1", False, 4), ("2x4x1", True, 8), ("2x2x2", True, 8), ("4x4x1", True, 6),
             ("1x1x1", False, 1)]


@pytest.mark.parametrize("shape, wrap, hosts", ARTIFACTS)
def test_gang_artifact_matches_the_reference(shape, wrap, hosts):
    probe = _synthetic_probe(shape, wrap)
    names = [f"h{i}" for i in range(hosts)]
    assert tf.gang_fabric_artifact(probe, names) == rf.gang_fabric_artifact(probe, names)


def test_gang_artifact_rejects_a_probe_without_shape():
    for fn in (tf.gang_fabric_artifact, rf.gang_fabric_artifact):
        with pytest.raises(ValueError, match="unparseable shape"):
            fn({"shape": "nope"}, ["a"])


def _live_probes():
    """One rank's probes and error messages (the tests assert on them)."""
    out = {shape: tf.run_fabric_probe(shape, wrap=wrap, size_mb=0.1, iters=2, device="cpu")
           for shape, wrap in LIVE.items()}
    for bad in ("not-a-shape", "4x4x4", "2x1x1"):
        try:
            tf.run_fabric_probe(bad, device="cpu")
        except ValueError as e:
            out[bad] = str(e)
    return out


@pytest.fixture(scope="module")
def world():
    return spawn_world(N, _live_probes, device="cpu", timeout=240)


@functools.lru_cache(maxsize=None)
def _reference(shape):
    import jax

    try:
        return rf.run_fabric_probe(shape, devices=jax.devices("cpu")[:N],
                                   wrap=LIVE.get(shape, False), size_mb=0.1, iters=2)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("shape", sorted(LIVE))
def test_live_probe_matches_the_reference(world, shape):
    want = _reference(shape)
    for rank_out in world:
        got = rank_out[shape]
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in ("edges", "axis_allreduce_us")} == {
            **{k: v for k, v in want.items() if k not in ("edges", "axis_allreduce_us")},
            "platform": "cpu"}
        assert sorted(got["edges"]) == sorted(want["edges"])
        assert {k: (v["axis"], v["wrap"]) for k, v in got["edges"].items()} == {
            k: (v["axis"], v["wrap"]) for k, v in want["edges"].items()}
        assert all(v["bw_gbps"] > 0 for v in got["edges"].values())
        assert set(got["axis_allreduce_us"]) == set(want["axis_allreduce_us"])
        assert all(v > 0 for v in got["axis_allreduce_us"].values())
    # every rank reports the same measurements
    assert len({str(r[shape]) for r in world}) == 1


def test_live_probe_roundtrips_into_the_artifact(world):
    probe = world[0]["4x1x1"]
    hosts = [f"h{i}" for i in range(N)]
    artifact = tf.gang_fabric_artifact(probe, hosts)
    assert artifact["hosts"] == N and len(artifact["edges"]) == len(probe["edges"]) == 4
    assert artifact["edges"][tf.edge_key("h0", "h3")]["wrap"]


@pytest.mark.parametrize("bad", ["not-a-shape", "4x4x4"])
def test_probe_errors_match_the_reference(world, bad):
    want = _reference(bad)
    assert isinstance(want, str)
    for rank_out in world:
        assert rank_out[bad] == want


def test_probe_takes_a_world_of_exactly_its_shape(world):
    for rank_out in world:
        assert rank_out["2x1x1"] == "shape 2x1x1 takes a world of exactly 2 ranks, have 4"

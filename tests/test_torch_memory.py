"""The same seeded random chunk traffic through the reference's
``HeteroMemory`` and the port's (on CPU tensors): victims, counters,
staging and OOM points must be identical step by step, and the payload
bytes must survive every real move the port makes."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import chunk as ref_chunk  # noqa: E402
from repro.core import manager as ref_manager  # noqa: E402
from repro.core import memory as ref_memory  # noqa: E402
from repro.core.state import TensorState as RefState  # noqa: E402
from repro_torch.core import chunk as port_chunk  # noqa: E402
from repro_torch.core import manager as port_manager  # noqa: E402
from repro_torch.core import memory as port_memory  # noqa: E402
from repro_torch.core.state import TensorState as PortState  # noqa: E402

SIZE = 8  # elements per tensor; two tensors per chunk
CHUNK = 2 * SIZE
CB = CHUNK * 4  # fp32 chunk bytes
N_TENSORS = 8  # four chunks per stream
STREAMS = ("p", "q")

REF = dict(chunk=ref_chunk, manager=ref_manager, memory=ref_memory,
           state=RefState, pool_kw={})
PORT = dict(chunk=port_chunk, manager=port_manager, memory=port_memory,
            state=PortState, pool_kw={"device": "cpu"})


def _ops(seed, n=70):
    """(stream, tensor, device, release) per moment; mostly device
    accesses, some host-side ones, releases HOLD or FREE."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append((STREAMS[rng.integers(len(STREAMS))],
                    f"t{rng.integers(N_TENSORS)}",
                    "host" if rng.random() < 0.15 else "device",
                    "free" if rng.random() < 0.2 else "hold"))
    return out


def _read(view):
    if isinstance(view, torch.Tensor):
        return view.detach().to("cpu", copy=True).numpy()
    return np.array(view, copy=True)


def _write(view, arr):
    if isinstance(view, torch.Tensor):
        view.copy_(torch.from_numpy(arr))
    else:
        view[...] = arr


def _snapshot(pool, mgrs):
    recs = tuple((s, r.chunk_id, r.location, r.payload is None)
                 for s, m in sorted(mgrs.items()) for r in m._records)
    return (recs, dataclasses.astuple(pool.stats),
            dataclasses.astuple(pool.prefetch), pool.device_bytes_used(),
            pool.host_bytes_used(), pool.slow_bytes_used(),
            pool.peak_device_bytes, sorted(pool.evictions.items()),
            sorted(pool._staged))


def _drive(pkg, ops, *, policy, device_chunks, host_chunks, slow_chunks):
    """Run ``ops`` through one package's pool; returns the per-step
    snapshots (ending with the OOM message, if any)."""
    specs = [pkg["chunk"].TensorSpec(f"t{i}", (SIZE,))
             for i in range(N_TENSORS)]
    cmap = pkg["chunk"].build_chunk_map(specs, CHUNK)
    pool = pkg["memory"].HeteroMemory(
        device_capacity_bytes=device_chunks * CB,
        host_capacity_bytes=None if host_chunks is None else host_chunks * CB,
        slow_capacity_bytes=None if slow_chunks is None else slow_chunks * CB,
        policy=policy, **pkg["pool_kw"])
    mgrs = {s: pkg["manager"].ChunkManager(cmap, name=s, pool=pool)
            for s in STREAMS}
    refs = []
    for s in STREAMS:
        sched: dict[int, list[int]] = {}
        for m, (s2, t, dev, _rel) in enumerate(ops):
            if s2 == s and dev == "device":
                cid = cmap.placement(t).chunk_id
                sched.setdefault(cid, []).append(m)
                refs.append((m, s, cid))
        pool.register_moments(s, sched)
    pf = pkg["memory"].SchedulePrefetcher(pool, lookahead=3, max_inflight=2)
    pf.install(refs)
    state = pkg["state"]
    expected: dict[tuple[str, str], np.ndarray] = {}
    trace = []
    for m, (s, t, dev, rel) in enumerate(ops):
        pool.set_moment(m)
        mgr = mgrs[s]
        fresh = mgr.tensor_state(t) is state.FREE
        try:
            pf.advance(m)
            view = mgr.access_tensor(t, dev)
        except pkg["memory"].OutOfMemory as exc:
            trace.append(("oom", m, str(exc)))
            break
        want = np.zeros(SIZE, np.float32) if fresh else expected[(s, t)]
        np.testing.assert_array_equal(_read(view), want)
        val = (np.arange(SIZE) + 100.0 * (m + 1)).astype(np.float32)
        _write(view, val)
        expected[(s, t)] = val
        mgr.release_tensor(t, state.FREE if rel == "free" else state.HOLD)
        pool.check_invariants()
        trace.append(_snapshot(pool, mgrs))
    return trace


TIERS = {
    "two-unbounded": dict(device_chunks=3, host_chunks=None,
                          slow_chunks=None),
    "two-bounded": dict(device_chunks=3, host_chunks=4, slow_chunks=None),
    "three": dict(device_chunks=2, host_chunks=3, slow_chunks=4),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tiers", sorted(TIERS))
@pytest.mark.parametrize("policy", ["opt", "lru", "fifo"])
def test_same_traffic_same_victims_counters_and_oom(policy, tiers, seed):
    ops = _ops(seed)
    kw = dict(policy=policy, **TIERS[tiers])
    ref = _drive(REF, ops, **kw)
    port = _drive(PORT, ops, **kw)
    assert len(port) == len(ref)
    for step, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"diverged at step {step}"
    moved = ref[-1][1] if ref[-1][0] != "oom" else ref[-2][1]
    assert moved[0] + moved[1] > 0  # chunks really moved between tiers


def test_oom_point_is_reached_and_identical():
    ops = [("p", f"t{2 * (i % 4)}", "device", "hold") for i in range(8)]
    ops += [("q", f"t{2 * (i % 4)}", "device", "hold") for i in range(8)]
    kw = dict(policy="opt", device_chunks=2, host_chunks=2, slow_chunks=None)
    ref = _drive(REF, ops, **kw)
    port = _drive(PORT, ops, **kw)
    assert ref[-1][0] == "oom"
    assert port == ref


def test_cpu_pool_keeps_payloads_on_their_tier():
    specs = [port_chunk.TensorSpec("a", (SIZE,)), port_chunk.TensorSpec(
        "b", (SIZE,))]
    cmap = port_chunk.build_chunk_map(specs, SIZE)
    mgr = port_manager.ChunkManager(cmap, name="s", device="cpu",
                                    device_capacity_bytes=SIZE * 4)
    view = mgr.access_tensor("a", "device")
    assert isinstance(view, torch.Tensor) and view.device.type == "cpu"
    view.fill_(7.0)
    mgr.release_tensor("a", PortState.HOLD)
    mgr.access_tensor("b", "device")  # evicts a's chunk: a real copy
    mgr.release_tensor("b", PortState.HOLD)
    assert mgr.location(0) == "host"
    assert torch.equal(mgr.tensor_view("a"), torch.full((SIZE,), 7.0))
    assert mgr.stats.d2h_bytes == SIZE * 4


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        port_memory.HeteroMemory(device_capacity_bytes=CB)


@pytest.mark.gpu
@pytest.mark.parametrize("tiers", sorted(TIERS))
@pytest.mark.parametrize("policy", ["opt", "lru"])
def test_cuda_pool_matches_reference(policy, tiers):
    """On the card every move is a real HBM/pinned copy (staged ones on
    the copy stream): the trace must still equal the reference's and the
    bytes must survive."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the device tier is HBM")
    ops = _ops(2)
    kw = dict(policy=policy, **TIERS[tiers])
    ref = _drive(REF, ops, **kw)
    cuda = dict(PORT, pool_kw={"device": "cuda"})
    assert _drive(cuda, ops, **kw) == ref

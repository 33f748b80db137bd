"""The port's mesh-sharded serving plane (nnstreamer_tpu_torch/parallel/
serve.py and the ``mesh=`` element property), case for case with the JAX
package's tests/test_mesh_serving.py: spec grammar, plan caching, batch
placement (zero-copy matched hand-offs, counted reshards), the
matched-sharding contract at device-passthrough boundaries, SLO admission
quantum alignment, mesh-wide batch forming, per-shard HBM residency, and
sharded swap_model continuity.

The port's mesh is a single controller over logical devices: on the CPU
the tests ask for 8 logical host devices (``set_host_device_count(8)``),
the counterpart of the JAX conftest's
``--xla_force_host_platform_device_count=8``. Where a case has a JAX
result to hold, both packages run it; the element outputs are
elementwise, so they are bit-identical.
"""

import gc
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.filters.jax_backend import (
    register_jax_model,
    unregister_jax_model,
)
from nnstreamer_tpu.parallel import serve as jserve
from nnstreamer_tpu_torch.elements.aggregator import TensorAggregator
from nnstreamer_tpu_torch.filters.torch_backend import (
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.obs import get_registry
from nnstreamer_tpu_torch.obs import timeline as _timeline
from nnstreamer_tpu_torch.parallel import P, make_mesh, serve
from nnstreamer_tpu_torch.parallel.serve import (
    MeshShardingError,
    canonical_spec,
    get_mesh_plan,
    parse_mesh_spec,
    place_batch,
)
from nnstreamer_tpu_torch.serving.scheduler import SloScheduler
from nnstreamer_tpu_torch.tensors import memory
from nnstreamer_tpu_torch.tensors.types import (
    TensorInfo,
    TensorsInfo,
    TensorType,
)

N_DEV = 8


@pytest.fixture(autouse=True)
def host_mesh():
    tnt.set_device("cpu")
    tnt.set_host_device_count(N_DEV)
    memory.deactivate()
    yield
    memory.deactivate()
    tnt.set_host_device_count(1)
    tnt.set_device(None)


def _wait(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() >= deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


# -- spec grammar and plans ---------------------------------------------------
class TestMeshSpec:
    def test_parse_simple(self):
        assert parse_mesh_spec("dp4") == [("dp", 4)]
        assert parse_mesh_spec("dp2xtp2") == [("dp", 2), ("tp", 2)]

    def test_parse_wildcard(self):
        assert parse_mesh_spec("dp*") == [("dp", -1)]
        assert parse_mesh_spec("dp") == [("dp", -1)]  # bare axis = rest
        assert parse_mesh_spec("tp2xdp-1") == [("tp", 2), ("dp", -1)]

    @pytest.mark.parametrize("spec", ["dp4", "dp2xtp2", "dp*", "dp",
                                      "tp2xdp-1", " DP8 "])
    def test_parse_equals_jax(self, spec):
        assert parse_mesh_spec(spec) == jserve.parse_mesh_spec(spec)

    @pytest.mark.parametrize("bad", ["", "qq4", "dp0", "4dp",
                                     "dp4q", "dp4xdp2"])
    def test_malformed_is_plan_time_error(self, bad):
        with pytest.raises(MeshShardingError):
            parse_mesh_spec(bad)
        with pytest.raises(jserve.MeshShardingError):
            jserve.parse_mesh_spec(bad)

    def test_canonical(self):
        assert canonical_spec("DP8") == canonical_spec("dp8")

    def test_plan_cached_and_counts_shards(self):
        a = get_mesh_plan("dp8")
        b = get_mesh_plan("dp8")
        assert a is b, "plans must cache per canonical spec"
        assert a.shard_count == 8 and a.dp_size == 8
        mixed = get_mesh_plan("dp2xtp2")
        assert mixed.shard_count == 4 and mixed.dp_size == 2

    def test_sharding_for_ragged_batch_falls_back(self):
        plan = get_mesh_plan("dp8")
        full = np.zeros((8, 4), np.float32)
        ragged = np.zeros((3, 4), np.float32)
        assert plan.sharding_for(full) == plan.batched()
        assert plan.sharding_for(ragged) == plan.replicated()

    def test_a_mesh_never_narrows(self):
        """``mesh=dp2`` on one device raises at plan time, as JAX's
        make_mesh does ("needs 2 devices, have 1")."""
        tnt.set_host_device_count(1)
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            get_mesh_plan("dp2")

    def test_cuda_requested_without_a_card_raises(self):
        tnt.set_device(None)
        if torch.cuda.is_available():
            pytest.skip("a card is present: the package device is real")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_mesh_plan("dp-1")


# -- batch placement (the zero-copy contract) ---------------------------------
class TestPlaceBatch:
    def test_matched_device_array_moves_zero_bytes(self):
        plan = get_mesh_plan("dp8")
        x = np.ones((8, 4), np.float32)
        r0 = serve.reshard_bytes_total()
        placed = place_batch(x, plan)
        assert placed.sharding == plan.batched()
        assert [tuple(s.data.shape) for s in placed.addressable_shards] \
            == [(1, 4)] * 8
        again = place_batch(placed, plan)
        assert again is placed, "matched hand-off must be a no-op"
        assert serve.reshard_bytes_total() == r0, \
            "matched placements must not count as reshards"

    def test_mismatched_device_array_counts_reshard(self):
        plan8 = get_mesh_plan("dp8")
        plan2 = get_mesh_plan("dp2")
        x = place_batch(np.ones((8, 4), np.float32), plan8)
        r0 = serve.reshard_bytes_total()
        moved = place_batch(x, plan2)
        assert moved.sharding == plan2.batched()
        assert serve.reshard_bytes_total() == r0 + x.nbytes, \
            "a cross-mesh bounce must count its bytes"
        assert torch.equal(moved.gather(), x.gather())

    def test_ragged_batch_places_replicated(self):
        plan = get_mesh_plan("dp8")
        placed = place_batch(np.ones((3, 4), np.float32), plan)
        assert placed.sharding == plan.replicated()

    def test_shards_hold_their_own_storage(self):
        """Each logical device holds its own copy: a replicated
        placement's shards share no storage."""
        plan = get_mesh_plan("dp8")
        placed = place_batch(np.ones((3, 4), np.float32), plan)
        ptrs = {s.data.data_ptr() for s in placed.addressable_shards}
        assert len(ptrs) == 8


# -- chained sharded regions: matched boundaries ------------------------------
class _Scale(torch.nn.Module):
    def __init__(self, k):
        super().__init__()
        self.k = k

    def forward(self, x):
        return x * self.k


class _Shift(torch.nn.Module):
    def forward(self, x):
        return x + 1.0


@pytest.fixture
def chain_models():
    register_torch_model("mesh_sv_a", _Scale(2.0))
    register_torch_model("mesh_sv_b", _Shift())
    register_jax_model("mesh_sv_a", lambda x: (x * 2.0,))
    register_jax_model("mesh_sv_b", lambda x: (x + 1.0,))
    yield "mesh_sv_a", "mesh_sv_b"
    unregister_torch_model("mesh_sv_a")
    unregister_torch_model("mesh_sv_b")
    unregister_jax_model("mesh_sv_a")
    unregister_jax_model("mesh_sv_b")


CHAIN_DESC = (
    "appsrc name=src ! "
    "tensor_filter framework=jax model=mesh_sv_a name=fa mesh=dp8 ! "
    "queue max-size-buffers=4 ! "
    "tensor_filter framework=jax model=mesh_sv_b name=fb mesh=dp8 ! "
    "tensor_sink name=sink to-host=true"
)


class TestChainedShardedRegions:
    def _run(self, desc, frames=4, pkg=tnt):
        pipe = pkg.parse_launch(desc)
        src, sink = pipe.get("src"), pipe.get("sink")
        pipe.start()
        try:
            for i in range(frames):
                src.push([np.full((8, 4), float(i), np.float32)])
            src.end_of_stream()
            msg = pipe.wait(timeout=120)
            assert msg is not None and msg.kind == "eos", msg
        finally:
            pipe.stop()
        return pipe, [np.asarray(b.tensors[0]) for b in sink.buffers]

    def test_zero_reshard_across_matched_boundary(self, chain_models):
        r0 = serve.reshard_bytes_total()
        pipe, outs = self._run(CHAIN_DESC)
        assert len(outs) == 4
        for i, o in enumerate(outs):
            assert np.array_equal(o, np.full((8, 4), i * 2.0 + 1.0,
                                             np.float32))
        assert serve.reshard_bytes_total() == r0, (
            "two chained dp8 regions must hand the batch off without "
            "moving a byte")
        assert pipe.get("fa")._mesh_handoff, \
            "the producer hands its sharded outputs on as they are"
        assert not pipe.get("fb")._mesh_handoff

    def test_chain_equals_jax(self, chain_models):
        _, ours = self._run(CHAIN_DESC)
        _, theirs = self._run(CHAIN_DESC, pkg=jnt)
        assert len(ours) == len(theirs) == 4
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)

    def test_shard_count_gauge_and_meta_stamp(self, chain_models):
        pipe, _ = self._run(CHAIN_DESC)
        g = get_registry().get("nns_shard_count",
                               pipeline=pipe.name, filter="fa")
        assert g is not None and float(g.value) == 8.0
        last = pipe.get("sink").buffers[-1]
        assert last.meta.get(serve.MESH_SPEC_META) == "dp8", \
            "sharded region output must carry its mesh-spec meta"

    def test_shard_span_recorded(self, chain_models):
        with _timeline.tracing() as tl:
            self._run(CHAIN_DESC)
            names = {ev["name"] for ev in tl.to_chrome()["traceEvents"]}
        assert "shard" in names, \
            "the placement wait must surface as its own ledger stage"

    def test_mismatched_boundary_is_plan_time_error(self, chain_models):
        desc = CHAIN_DESC.replace("model=mesh_sv_b name=fb mesh=dp8",
                                  "model=mesh_sv_b name=fb mesh=dp2xtp2")
        pipe = tnt.parse_launch(desc)
        try:
            with pytest.raises(MeshShardingError, match="fa.*fb|reshard"):
                pipe.start()
        finally:
            pipe.stop()

    def test_mixed_specs_in_one_region_rejected(self, chain_models):
        desc = CHAIN_DESC.replace("queue max-size-buffers=4 ! ", "")
        desc = desc.replace("model=mesh_sv_b name=fb mesh=dp8",
                            "model=mesh_sv_b name=fb mesh=dp4")
        pipe = tnt.parse_launch(desc)
        try:
            with pytest.raises(MeshShardingError):
                pipe.start()
        finally:
            pipe.stop()

    def test_fused_sharded_region_one_dispatch_per_shard(self, chain_models):
        """Without the queue the two filters fuse into one sharded region:
        each frame runs the composed stages once per mesh device."""
        desc = CHAIN_DESC.replace("queue max-size-buffers=4 ! ", "")
        pipe, outs = self._run(desc)
        (region,) = pipe.metrics_snapshot()["regions"].values()
        assert region["eager_frames"] == 4 * N_DEV
        for i, o in enumerate(outs):
            assert np.array_equal(o, np.full((8, 4), i * 2.0 + 1.0,
                                             np.float32))
        assert pipe.get("sink").buffers[-1].meta[serve.MESH_SPEC_META] \
            == "dp8"


# -- admission quantum + mesh-wide batch forming ------------------------------
class TestMeshQuantum:
    def test_scheduler_batch_cap_rounds_to_quantum(self):
        sched = SloScheduler(budget_ms=50.0)
        sched.note_mesh(8)
        sched.controller.batch_cap = 21
        assert sched.batch_cap() == 16, "cap rounds DOWN to a dp multiple"
        sched.controller.batch_cap = 3
        assert sched.batch_cap() == 8, "cap never rounds below one window"
        assert sched.snapshot()["mesh_quantum"] == 8

    def test_scheduler_quantum_one_is_identity(self):
        sched = SloScheduler(budget_ms=50.0)
        cap = sched.batch_cap()
        sched.note_mesh(1)
        assert sched.batch_cap() == cap

    def test_aggregator_rounds_frames_out_up(self):
        agg = TensorAggregator("agg", frames_out=12)
        agg.note_mesh_quantum(8)
        assert int(agg.get_property("frames_out")) == 16
        agg.note_mesh_quantum(8)  # idempotent once aligned
        assert int(agg.get_property("frames_out")) == 16

    def test_aggregator_passthrough_untouched(self):
        agg = TensorAggregator("agg", frames_out=1)
        agg.note_mesh_quantum(8)
        assert int(agg.get_property("frames_out")) == 1, \
            "per-frame service must stay per-frame"

    def test_pipeline_start_aligns_batch_former(self, chain_models):
        pipe = tnt.parse_launch(
            "appsrc name=src ! "
            "tensor_aggregator name=agg frames-in=1 frames-out=6 "
            "frames-dim=1 concat=true ! "
            "tensor_filter framework=jax model=mesh_sv_a mesh=dp8 ! "
            "tensor_sink name=sink to-host=true")
        src = pipe.get("src")
        pipe.start()
        try:
            assert int(pipe.get("agg").get_property("frames_out")) == 8, \
                "start() must round the former's window to the dp fan-out"
            for i in range(8):
                src.push([np.full((1, 4), float(i), np.float32)])
            src.end_of_stream()
            msg = pipe.wait(timeout=120)
            assert msg is not None and msg.kind == "eos", msg
        finally:
            pipe.stop()
        outs = [np.asarray(b.tensors[0])
                for b in pipe.get("sink").buffers]
        assert len(outs) == 1 and outs[0].shape == (8, 4)
        assert np.array_equal(
            outs[0], np.arange(8, dtype=np.float32)[:, None]
            .repeat(4, 1) * 2.0)


# -- per-shard HBM residency + sharded swap continuity ------------------------
class _Weighted(torch.nn.Module):
    def __init__(self, shape, scale):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(shape) * scale,
                                    requires_grad=False)

    def forward(self, x):
        return x.float() * self.w[0, 0]


class TestPerShardResidency:
    SHAPE = (64, 64)

    def _register(self, name, scale):
        register_torch_model(name, _Weighted(self.SHAPE, scale))
        return int(np.prod(self.SHAPE)) * 4

    def _desc(self):
        return ("appsrc name=src ! tensor_filter framework=jax "
                "model=mesh_sv_w name=filter mesh=dp8 ! "
                "tensor_sink name=sink to-host=true")

    def test_weights_account_once_per_shard(self):
        nbytes = self._register("mesh_sv_w", 2.0)
        try:
            acct = memory.activate(64 * nbytes)
            pipe = tnt.parse_launch(self._desc())
            src, sink = pipe.get("src"), pipe.get("sink")
            pipe.start()
            try:
                src.push([np.full((8, 4), 1.0, np.float32)])
                _wait(lambda: len(sink.buffers) >= 1, what="warm frame")
                assert acct._used.get("weights", 0) == 8 * nbytes, (
                    "a replicated dp8 placement is a full weight copy "
                    "per device — nns_mem_used_bytes must count all 8")
                shard_keys = [k for k in acct.residency._units
                              if ":shard" in k]
                assert len(shard_keys) == 8
                src.end_of_stream()
                msg = pipe.wait(timeout=120)
                assert msg is not None and msg.kind == "eos", msg
            finally:
                pipe.stop()
            assert np.array_equal(np.asarray(sink.buffers[0].tensors[0]),
                                  np.full((8, 4), 2.0, np.float32))
        finally:
            unregister_torch_model("mesh_sv_w")

    def test_sharded_swap_retires_group_zero_drops(self):
        nbytes = self._register("mesh_sv_w", 2.0)
        try:
            acct = memory.activate(64 * nbytes)
            pipe = tnt.parse_launch(self._desc())
            src, sink = pipe.get("src"), pipe.get("sink")
            pipe.start()
            try:
                for i in range(5):
                    src.push([np.full((8, 4), float(i), np.float32)])
                _wait(lambda: len(sink.buffers) >= 5, what="first 5")
                used_before = acct.used_bytes()
                keys_before = {k for k in acct.residency._units
                               if ":shard" in k}
                assert len(keys_before) == 8

                new = {"w": torch.ones(self.SHAPE) * 5.0}
                report = pipe.swap_model("filter", weights=new)

                assert acct.used_bytes() == used_before, \
                    "per-shard swap must retire the whole old group"
                keys_after = {k for k in acct.residency._units
                              if ":shard" in k}
                assert len(keys_after) == 8
                assert keys_before.isdisjoint(keys_after)
                assert all(":e1:" in k for k in keys_after), \
                    "new group must be keyed by the bumped epoch"
                assert report["residency_unit"].endswith(":e1")

                src.push([np.full((8, 4), 1.0, np.float32)])
                _wait(lambda: len(sink.buffers) >= 6, what="post-swap")
                fw = pipe.get("filter").fw
                replicas = list(fw._replicas)
                for i in range(4):
                    src.push([np.full((8, 4), float(i), np.float32)])
                src.end_of_stream()
                msg = pipe.wait(timeout=120)
                assert msg is not None and msg.kind == "eos", msg
                assert all(a is b for a, b in zip(fw._replicas, replicas)), \
                    "a weights-only swap places the copies once, not per frame"
            finally:
                pipe.stop()
            outs = [np.asarray(b.tensors[0]) for b in sink.buffers]
            assert len(outs) == 10, "swap dropped frames"
            for i in range(5):  # old epoch: x * 2
                assert np.array_equal(
                    outs[i], np.full((8, 4), i * 2.0, np.float32))
            assert np.array_equal(outs[5],
                                  np.full((8, 4), 5.0, np.float32))
            for i, o in enumerate(outs[6:]):  # new epoch: x * 5
                assert np.array_equal(
                    o, np.full((8, 4), i * 5.0, np.float32))
        finally:
            unregister_torch_model("mesh_sv_w")


class TestPlacementAccounting:
    def test_place_params_registers_pinned_bytes(self):
        acct = memory.activate(1 << 30)
        mesh = make_mesh([("dp", 8)])
        params = {"w": np.ones((16, 16), np.float32)}
        placed = serve.place_params(params, mesh, {"w": P()},
                                    label="test:pinned")
        used = acct._used.get("weights", 0)
        assert used >= 8 * params["w"].nbytes, (
            "a replicated placement occupies every device; the accountant "
            "must see the full multi-device footprint")
        pinned = [u for u in acct.residency.snapshot()["units"]
                  if u["pinned"]]
        assert pinned, "external placements adopt as pinned units"
        del placed
        gc.collect()
        assert acct._used.get("weights", 0) < used, \
            "dropping the placement must release its adopted bytes"


# -- the kill switch ----------------------------------------------------------
def test_kill_switch_keeps_the_single_device_path(chain_models, monkeypatch):
    monkeypatch.setenv("NNSTPU_MESH", "0")
    pipe = tnt.parse_launch(CHAIN_DESC)
    src, sink = pipe.get("src"), pipe.get("sink")
    pipe.start()
    try:
        assert pipe.get("fa").fw._mesh_plan is None, \
            "kill switch must keep the backend planless"
        src.push([np.full((8, 4), 3.0, np.float32)])
        src.end_of_stream()
        msg = pipe.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
    finally:
        pipe.stop()
    assert np.array_equal(np.asarray(sink.buffers[0].tensors[0]),
                          np.full((8, 4), 7.0, np.float32))
    assert serve.MESH_SPEC_META not in sink.buffers[0].meta


# -- offload into a sharded filter (tests/test_query.py) -----------------------
class _ScaleBy2(torch.nn.Module):
    def forward(self, x):
        return x.float() * 2.0


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_offload_into_sharded_filter(server_pkg):
    """Frames arrive over the query protocol and the server's filter
    shards the batch over every device of the mesh
    (``custom=sharding:batch``): the port's client gets each frame
    doubled from a port server, as from a JAX one."""
    # a classic serversrc's caps carry no shapes: the model declares them
    info = TensorsInfo([TensorInfo(dim=(4, N_DEV), type=TensorType.FLOAT32)])
    register_torch_model("sharded_scale", _ScaleBy2(), info, info)
    register_jax_model("sharded_scale",
                       lambda p, x: x.astype(np.float32) * p, np.float32(2.0))
    pkg = tnt if server_pkg == "port" else jnt
    server = pkg.parse_launch(
        "tensor_query_serversrc name=ssrc port=0 ! "
        "tensor_filter framework=jax model=sharded_scale name=f "
        "custom=sharding:batch ! tensor_query_serversink")
    server.start()
    client = None
    try:
        if server_pkg == "port":
            fw = server.get("f").fw
            assert fw._sharding.num_devices == N_DEV
            assert fw.device_stage() is None, \
                "custom=sharding: is not fusible"
        port = server.get("ssrc").port
        client = tnt.parse_launch(
            "appsrc name=src ! "
            f"tensor_query_client dest-host=127.0.0.1 dest-port={port} "
            "max-in-flight=4 ! tensor_sink name=out")
        src, sink = client.get("src"), client.get("out")
        client.start()
        for j in range(6):
            src.push([np.full((N_DEV, 4), j, np.float32)])
        src.end_of_stream()
        msg = client.wait(timeout=60)
        assert msg is not None and msg.kind == "eos", msg
        assert len(sink.buffers) == 6
        for j, b in enumerate(sink.buffers):
            np.testing.assert_array_equal(
                np.asarray(b.to_host().tensors[0]),
                np.full((N_DEV, 4), j * 2.0, np.float32))
    finally:
        if client is not None:
            client.stop()
        server.stop()
        unregister_torch_model("sharded_scale")
        unregister_jax_model("sharded_scale")

"""The port's N-to-1 elements and fan-out: ``CollectPads`` and its four
sync policies (``elements/collect.py``), ``tensor_mux``, ``tensor_merge``
and ``tee``, held to the JAX package's.

The policies run on scripted pts sequences through both packages'
``CollectPads``: the frame-sets (pad index and pts of each member) must be
equal, set by set. The mux, merge and named-pad launch strings of
``tests/test_golden_pipelines.py`` (their ``filesink`` replaced by a
``tensor_sink``) give the same tensors in both packages and equal the
numpy goldens. All on the CPU.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

import nnstreamer_tpu as jnt
import nnstreamer_tpu_torch as tnt
from nnstreamer_tpu.elements.collect import CollectPads as JaxCollectPads
from nnstreamer_tpu.tensors.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.elements.collect import CollectPads
from nnstreamer_tpu_torch.elements.merge import merge_tensors
from nnstreamer_tpu_torch.tensors.buffer import TensorBuffer

EOS = "eos"

# (policy, option, pads, script): a script step is (pad, pts) — a push —
# or (pad, EOS), or ("recheck",)
SCRIPTS = {
    "nosync": ("nosync", "", 3, [
        (0, 0), (1, 5), (0, 10), (2, 1), (2, 11), (1, 15), (0, 20),
        (1, 25), (2, 21), (0, EOS), (1, 35), (2, 31), (1, EOS), (2, EOS)]),
    "slowest": ("slowest", "", 2, [
        (0, 0), (0, 10), (1, 0), (0, 20), (0, 30), (1, 20), (0, 40),
        (1, 40), (0, 50), (1, 60), (0, EOS), (1, 80), (1, EOS)]),
    "slowest_skew": ("slowest", "", 3, [
        (0, 0), (1, 30), (0, 10), (0, 20), (0, 30), (0, 40), (2, 35),
        (2, 45), (1, 60), (0, 50), (0, 60), (2, 70), (1, 90), (0, 100)]),
    "basepad": ("basepad", "0:15", 3, [
        (1, 0), (2, 0), (0, 0), (1, 10), (1, 20), (0, 10), (2, 30),
        (1, 30), (0, 20), (0, 40), (2, 50), (1, 60), (0, 60)]),
    "basepad_nowindow": ("basepad", "1", 2, [
        (0, 0), (0, 10), (1, 5), (0, 20), (1, 15), (1, 25), (0, 30),
        (1, 35)]),
    "refresh": ("refresh", "", 3, [
        (0, 0), (1, 0), (0, 10), (2, 0), (1, 10), (1, 20), (2, 10),
        (0, 20), (2, EOS), (0, 30), (1, 30)]),
    "recheck": ("slowest", "", 2, [
        (0, 0), (0, 10), (0, 20), (1, 0), (1, EOS), ("recheck",),
        (0, 30), ("recheck",)]),
}


def _play(cls, buf_cls, policy, option, pads, script):
    out = []
    cp = cls(pads, policy, option,
             on_ready=lambda f: out.append([(i, b.pts) for i, b in f]))
    eos = []
    for step in script:
        if step[0] == "recheck":
            cp.recheck()
        elif step[1] == EOS:
            eos.append(cp.set_eos(step[0]))
        else:
            cp.push(step[0], buf_cls([np.zeros(1, np.uint8)], pts=step[1]))
    flushed = [[(i, b.pts) for i, b in f] for f in cp.flush_remaining()]
    return out, eos, flushed


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_policy_frame_sets_match_jax(name):
    policy, option, pads, script = SCRIPTS[name]
    want = _play(JaxCollectPads, JaxBuffer, policy, option, pads, script)
    got = _play(CollectPads, TensorBuffer, policy, option, pads, script)
    assert want[0], "the script emits no frame-set"
    assert got == want


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown sync policy"):
        CollectPads(2, "fastest")
    with pytest.raises(ValueError, match="refresh"):
        CollectPads(2, "refresh").recheck()


def test_sync_wait_observed_once_per_set():
    waits = []
    cp = CollectPads(2, "nosync", on_ready=lambda f: None,
                     observe_wait=waits.append)
    b0 = TensorBuffer([np.zeros(1)], pts=0)
    cp.push(0, b0)
    time.sleep(0.02)
    cp.push(1, TensorBuffer([np.zeros(1)], pts=0))
    assert len(waits) == 1 and waits[0] >= 0.02
    assert "_collect_arrive_t" not in b0.meta


def test_frame_sets_leave_one_at_a_time_in_order():
    """Four producer threads: the consumer is never entered by two at once
    (a fused region's static inputs would be overwritten), and the sets
    leave in pts order."""
    n, pads = 60, 4
    active, overlaps, seen = [0], [0], []
    lock = threading.Lock()

    def consume(frame):
        with lock:
            active[0] += 1
            overlaps[0] = max(overlaps[0], active[0])
        time.sleep(0.0005)
        seen.append(frame[0][1].pts)
        with lock:
            active[0] -= 1

    cp = CollectPads(pads, "slowest", on_ready=consume)

    def produce(pad):
        for i in range(n):
            cp.push(pad, TensorBuffer([np.zeros(1)], pts=i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=produce, args=(p,))
                   for p in range(pads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert overlaps[0] == 1
    assert seen == sorted(seen) and len(seen) == n


# -- launch strings of tests/test_golden_pipelines.py --------------------------
@pytest.fixture
def cpu_device():
    tnt.set_device("cpu")
    yield
    tnt.set_device(None)


def _sink_tensors(pkg, desc, sinks=("out",)):
    pipe = pkg.parse_launch(desc)
    got = {s: [] for s in sinks}
    for s in sinks:
        pipe.get(s).connect(
            lambda b, s=s: got[s].append([np.asarray(t) for t in b.tensors]))
    msg = pipe.run(timeout=120)
    assert msg is not None and msg.kind == "eos", msg
    return got if len(sinks) > 1 else got[sinks[0]]


def _src_frames(n, w, h, pattern="gradient"):
    return [f for (f,) in _sink_tensors(
        jnt, f"videotestsrc num-buffers={n} width={w} height={h} "
        f"pattern={pattern} ! tensor_converter ! tensor_sink name=out")]


MUX_STRINGS = {
    # test_golden_mux_two_sources
    "mux_two_sources": (
        "tensor_mux name=m sync-mode=nosync ! tensor_sink name=out "
        "videotestsrc num-buffers=5 width=8 height=8 pattern=gradient ! "
        "tensor_converter ! m. "
        "videotestsrc num-buffers=5 width=8 height=8 pattern=black ! "
        "tensor_converter ! m.",
        lambda: [[a, b] for a, b in zip(_src_frames(5, 8, 8, "gradient"),
                                        _src_frames(5, 8, 8, "black"))]),
    # test_golden_merge_linear
    "merge_linear": (
        "tensor_merge name=m mode=linear option=0 sync-mode=slowest ! "
        "tensor_sink name=out  "
        "videotestsrc num-buffers=3 width=8 height=8 pattern=gradient ! "
        "tensor_converter ! m.  "
        "videotestsrc num-buffers=3 width=8 height=8 pattern=gradient ! "
        "tensor_converter ! m.",
        lambda: [[np.concatenate([f, f], axis=-1)]
                 for f in _src_frames(3, 8, 8)]),
    # test_golden_named_sink_pads_fix_mux_order
    "named_sink_pads": (
        "tensor_mux name=m sync-mode=nosync ! tensor_sink name=out "
        "videotestsrc num-buffers=3 width=8 height=8 pattern=black ! "
        "tensor_converter ! m.sink_1 "
        "videotestsrc num-buffers=3 width=8 height=8 pattern=gradient ! "
        "tensor_converter ! m.sink_0",
        lambda: [[a, b] for a, b in zip(_src_frames(3, 8, 8, "gradient"),
                                        _src_frames(3, 8, 8, "black"))]),
    # the pose4 shape: four sources, slowest
    "mux_four_slowest": (
        "tensor_mux name=m sync-mode=slowest ! tensor_sink name=out " +
        " ".join(f"videotestsrc num-buffers=4 width=8 height=8 pattern={p} "
                 "! tensor_converter ! m." for p in
                 ("gradient", "black", "ball", "smpte")),
        lambda: [list(fs) for fs in zip(*(
            _src_frames(4, 8, 8, p)
            for p in ("gradient", "black", "ball", "smpte")))]),
}


@pytest.mark.parametrize("name", sorted(MUX_STRINGS))
def test_mux_and_merge_strings_match_jax(cpu_device, name):
    desc, golden = MUX_STRINGS[name]
    want = _sink_tensors(jnt, desc)
    got = _sink_tensors(tnt, desc)
    gold = golden()
    assert len(got) == len(want) == len(gold)
    for g, w, o in zip(got, want, gold):
        assert [t.tobytes() for t in g] == [t.tobytes() for t in w] == \
            [t.tobytes() for t in o]


def test_mux_caps_name_every_pad_tensor(cpu_device):
    pipe = tnt.parse_launch(MUX_STRINGS["mux_two_sources"][0])
    pipe.run(timeout=60)
    caps = pipe.get("out").sinkpads[0].caps
    config = tnt.TensorsConfig.from_caps(caps)
    assert [i.dim for i in config.info] == [(3, 8, 8, 1), (3, 8, 8, 1)]


def test_mux_pad_limit():
    from nnstreamer_tpu_torch.elements.mux import TensorMux

    mux = TensorMux()
    for _ in range(tnt.NNS_TENSOR_SIZE_LIMIT):
        mux.request_sink_pad()
    with pytest.raises(ValueError, match="max 16 pads"):
        mux.request_sink_pad()


def test_merge_concatenates_tensors_where_they_lie():
    a = np.arange(24, dtype=np.float32).reshape(1, 2, 3, 4)
    b = a + 100
    want = np.concatenate([a, b], axis=2)  # dim 1 → axis 2
    host = merge_tensors([a, b], 1)
    assert isinstance(host, np.ndarray)
    np.testing.assert_array_equal(host, want)
    dev = merge_tensors([torch.from_numpy(a), b], 1)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), want)


def test_tee_fans_out_to_every_branch(cpu_device):
    desc = ("videotestsrc num-buffers=3 width=8 height=8 pattern=ball ! "
            "tensor_converter ! tee name=t  t. ! queue ! tensor_sink name=a  "
            "t. ! tensor_sink name=b")
    want = _sink_tensors(jnt, desc, ("a", "b"))
    got = _sink_tensors(tnt, desc, ("a", "b"))
    for s in ("a", "b"):
        assert len(got[s]) == 3
        assert [f[0].tobytes() for f in got[s]] == \
            [f[0].tobytes() for f in want[s]]
    assert [f[0].tobytes() for f in got["a"]] == \
        [f[0].tobytes() for f in got["b"]]


def test_tee_drops_the_staging_claim():
    """A fanned-out buffer loses its pool stash and exclusivity marker:
    no branch may recycle or clear a payload another still reads."""
    from nnstreamer_tpu_torch.elements.tee import Tee
    from nnstreamer_tpu_torch.pipeline.dispatch import POOL_STASH_META
    from nnstreamer_tpu_torch.pipeline.element import Element
    from nnstreamer_tpu_torch.tensors.buffer import H2D_EXCLUSIVE_META

    class Catch(Element):
        def __init__(self):
            super().__init__()
            self.add_sink_pad("sink")
            self.got = []

        def chain(self, pad, buf):
            self.got.append(buf)

    tee, a, b = Tee(), Catch(), Catch()
    tee.link(a)
    tee.link(b)
    buf = TensorBuffer([np.zeros(2)], meta={POOL_STASH_META: [1],
                                            H2D_EXCLUSIVE_META: True, "k": 1})
    tee.chain(tee.sinkpad, buf)
    for c in (a, b):
        (out,) = c.got
        assert POOL_STASH_META not in out.meta
        assert H2D_EXCLUSIVE_META not in out.meta and out.meta["k"] == 1
    assert POOL_STASH_META in buf.meta  # the sender's buffer is untouched


@pytest.mark.parametrize("name", ["mux_four_slowest", "merge_linear"])
def test_restarted_pipeline_collects_anew(cpu_device, name):
    """A restarted port pipeline streams again (``Pipeline.start()``
    clears every pad's EOS); the mux and merge collect anew, without the
    last run's EOS marks: the second run's output is the first's (ROADMAP
    queue C.20: the JAX package keeps them)."""
    desc, golden = MUX_STRINGS[name]
    pipe = tnt.parse_launch(desc)
    got = []
    pipe.get("out").connect(
        lambda b: got.append([np.asarray(t).tobytes() for t in b.tensors]))
    for _ in range(2):
        msg = pipe.run(timeout=120)
        assert msg is not None and msg.kind == "eos", msg
    gold = [[t.tobytes() for t in fs] for fs in golden()]
    assert got == gold + gold


# -- on the card ---------------------------------------------------------------
@pytest.mark.gpu
def test_mux_and_merge_keep_card_payloads_on_the_card():
    """CUDA tensors cross ``tensor_mux`` by reference and ``tensor_merge``
    concatenates them on the card: nothing moves to the host."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the payloads live on the card")
    from nnstreamer_tpu_torch.elements.merge import TensorMerge
    from nnstreamer_tpu_torch.elements.mux import TensorMux
    from nnstreamer_tpu_torch.pipeline.element import Element

    class Catch(Element):
        def __init__(self):
            super().__init__()
            self.add_sink_pad("sink")
            self.got = []

        def chain(self, pad, buf):
            self.got.append(buf)

    a = torch.arange(6.0, device="cuda").reshape(1, 2, 3)
    b = a + 10
    for el in (TensorMux(sync_mode="nosync"),
               TensorMerge(option="0", sync_mode="nosync")):
        pads = [el.request_sink_pad(), el.request_sink_pad()]
        out = Catch()
        el.link(out)
        for pad, t in zip(pads, (a, b)):
            el.chain(pad, TensorBuffer([t], pts=0))
        (buf,) = out.got
        if isinstance(el, TensorMux):
            assert buf.tensors[0] is a and buf.tensors[1] is b
        else:
            (merged,) = buf.tensors
            assert merged.device.type == "cuda"
            assert torch.equal(merged.cpu(), torch.cat([a, b], 2).cpu())

"""tensor_lm_serve — LM serving as a pipeline element.

Drops the continuous-batching engine (serving/engine.py) into a pipeline:

    appsrc ! tensor_lm_serve engine=E ! tensor_sink

Each arriving buffer is a prompt (int32 ids, flattened); the element
submits it to the shared engine and returns ONE completion buffer (the
generated ids) when the stream finishes. Submission is asynchronous:
every in-flight request decodes in the same batched device loop, and
completions flow downstream as they finish —

- ACROSS clients (``query_client_id`` meta): out of order, so a short
  prompt never waits on a long one;
- WITHIN a client: strictly FIFO (a per-client drainer pushes that
  client's completions in submission order).

Per-request overrides: a SECOND int32 tensor in the request buffer caps
generation for that prompt; in-process pipelines may use ``lm_max_new``
buffer meta instead. The completion buffer carries ``lm_finish_reason``
and ``lm_prompt_len`` meta, preserves everything else, and holds TWO
tensors: the generated ids (int32) and the model's per-token logprobs
(float32).

Failure contract: every request gets exactly one response — a request
that fails (bad prompt, engine error, result timeout) returns a single
``-1`` token (ids are never negative). Per-client drainers retire after
``idle_timeout`` seconds without traffic; a completion that races the
idle window is handed to a fresh drainer rather than dropped.

A copy of the JAX package's element. It serves remote clients behind the
query pair as it serves an in-process ``appsrc``::

    tensor_query_serversrc port=P id=I ! tensor_lm_serve engine=E !
    tensor_query_serversink id=I

``speculate=K`` (and ``speculate-layers=N``, the draft's depth; 0 = the
engine's default) turns the engine's speculative decoding on at
``start()`` (``ContinuousBatchingEngine.set_speculate``), which raises if
the engine is already running with another K.
"""

from __future__ import annotations

import queue as _queue
import threading
import time
from typing import Dict

import numpy as np

from nnstreamer_tpu_torch.pipeline.element import (
    Element,
    EosEvent,
    FlowError,
    FlowReturn,
)
from nnstreamer_tpu_torch.registry import ELEMENT, subplugin
from nnstreamer_tpu_torch.tensors.buffer import host_array


@subplugin(ELEMENT, "tensor_lm_serve")
class TensorLMServe(Element):
    ELEMENT_NAME = "tensor_lm_serve"
    PROPERTIES = {
        **Element.PROPERTIES,
        "engine": "",            # registered engine name (serving package)
        "max_new_tokens": 64,    # default generation budget per request
        "timeout": 600.0,        # seconds a drainer waits on one result
        "idle_timeout": 60.0,    # seconds before an idle drainer retires
        "speculate": 0,          # draft-then-verify lookahead (engine knob)
        "speculate_layers": 0,   # draft depth override (0 = engine default)
    }

    #: error response payload — exactly one buffer per request keeps the
    #: order-matched framed protocol in sync (see module docstring)
    ERROR_TOKEN = -1

    _EOS = object()

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.add_sink_pad("sink")
        self.add_src_pad("src")
        self._engine = None
        from nnstreamer_tpu_torch.utils.stats import InvokeStats

        #: submit→completion wall time per request (the base ``stats``
        #: window only times the synchronous chain() hand-off, which for
        #: an async element is meaningless µs)
        self.request_stats = InvokeStats()
        self._fifos: Dict[int, _queue.Queue] = {}
        #: cid → stream the drainer is currently waiting on (for
        #: cancel-on-stop/EOS-timeout coverage of dequeued items)
        self._current: Dict[int, object] = {}
        self._drainers: Dict[int, threading.Thread] = {}
        self._state_lock = threading.Lock()
        self._push_lock = threading.Lock()  # serialize downstream pushes
        self._inflight = 0
        self._stopped = False  # set under _state_lock; _enqueue rejects
        self._idle = threading.Condition(self._state_lock)

    def start(self):
        super().start()
        with self._state_lock:
            self._stopped = False
        from nnstreamer_tpu_torch.serving import get_engine

        name = self.get_property("engine")
        self._engine = get_engine(name)
        if self._engine is None:
            raise FlowError(
                f"{self.name}: no engine registered as {name!r} "
                f"(serving.register_engine first)")
        spec = int(self.get_property("speculate"))
        if spec and spec != getattr(self._engine, "speculate", 0):
            # opt-in draft-then-verify: the knob is the element's, the
            # machinery the engine's (models/speculative.py); set_speculate
            # raises if the engine is already decoding with another K — a
            # conflict that fails start()
            layers = int(self.get_property("speculate_layers")) or None
            self._engine.set_speculate(spec, draft_layers=layers)

    def _cancel_all_inflight(self):
        """Nobody will read these streams anymore — the engine must not
        keep decoding into them (their slots free at the next block
        boundary)."""
        with self._state_lock:
            fifos = list(self._fifos.values())
            current = list(self._current.values())
        for st in current:
            if st is not None:
                st.cancel()
        for f in fifos:
            for item in list(f.queue):
                if isinstance(item, tuple) and item[0] is not None:
                    item[0].cancel()

    def stop(self):
        self._cancel_all_inflight()
        with self._state_lock:
            # chain() racing stop() must not recreate fifos/drainers after
            # this point — _enqueue pushes an error response instead
            self._stopped = True
            fifos = list(self._fifos.values())
            self._fifos.clear()
            drainers = list(self._drainers.values())
            self._drainers.clear()
            self._current.clear()
        for f in fifos:
            f.put(self._EOS)
        for t in drainers:
            t.join(timeout=5)
        self._engine = None
        super().stop()

    # -- request intake -------------------------------------------------------
    def chain(self, pad, buf):
        cid = int(buf.meta.get("query_client_id", 0))
        try:
            # a prompt is a few host ints: a device tensor is fetched
            prompt = np.asarray(host_array(
                buf.tensors[0])).reshape(-1).astype(np.int32)
            max_new = int(self.get_property("max_new_tokens"))
            if len(buf.tensors) > 1:  # budget as payload (survives wire)
                max_new = int(np.asarray(host_array(
                    buf.tensors[1])).reshape(-1)[0])
            max_new = int(buf.meta.get("lm_max_new", max_new))
            stream = self._engine.submit(prompt, max_new_tokens=max_new)
            self._enqueue(cid, (stream, buf, None, time.monotonic()))
        except Exception as e:  # noqa: BLE001
            # a malformed remote
            # request must not error the server pipeline (remote DoS);
            # its error response goes through the SAME per-client fifo so
            # it cannot overtake earlier in-flight completions (the wire
            # matches responses to requests by order)
            self.log.warning("client %d request rejected: %s", cid, e)
            self._enqueue(cid, (None, buf, str(e), time.monotonic()))
        return FlowReturn.OK

    def _enqueue(self, cid: int, item) -> None:
        with self._state_lock:
            if self._stopped:
                rejected = item
            else:
                rejected = None
                fifo = self._fifos.get(cid)
                if fifo is None:
                    fifo = self._fifos[cid] = _queue.Queue()
                    t = threading.Thread(target=self._drain,
                                         args=(cid, fifo),
                                         name=f"{self.name}-c{cid}",
                                         daemon=True)
                    self._drainers[cid] = t
                    t.start()
                self._inflight += 1
                fifo.put(item)
        if rejected is not None:
            # element stopped between chain() and here: the client still
            # gets its error response, and no drainer is recreated
            stream, buf, _err, _t0 = rejected
            if stream is not None:
                stream.cancel()
            self._push_response(
                self._error_response(buf, "server stopped"))

    def _error_response(self, buf, reason: str):
        return buf.with_tensors(
            [np.asarray([self.ERROR_TOKEN], np.int32)]).replace(
                meta={**buf.meta, "lm_finish_reason": f"error: {reason}"})

    def _push_response(self, out):
        with self._push_lock:
            self.srcpad.push(out)

    def _adopt_orphans_locked(self, cid: int, items) -> None:
        """Hand completions orphaned by a retiring drainer to a fresh
        one. Caller holds ``_state_lock`` and has already removed the
        old fifo/drainer for ``cid``, so registering here is
        race-free; ``_inflight`` was counted at original enqueue and
        must NOT be bumped again. (``stop()`` clears the fifo map in
        the same critical section that sets ``_stopped``, so reaching
        this path implies the element is still running.)"""
        fifo = self._fifos[cid] = _queue.Queue()
        for item in items:
            fifo.put(item)
        t = threading.Thread(target=self._drain, args=(cid, fifo),
                             name=f"{self.name}-c{cid}", daemon=True)
        self._drainers[cid] = t
        t.start()

    # -- per-client completion drainer ---------------------------------------
    def _drain(self, cid: int, fifo: _queue.Queue):
        timeout = float(self.get_property("timeout"))
        idle = float(self.get_property("idle_timeout"))
        while True:
            try:
                item = fifo.get(timeout=idle)
            except _queue.Empty:
                # Retire — carefully. A completion can land in the fifo
                # between the idle timeout firing and the removal below
                # (the engine finishes a stream just as the window
                # closes). Dropping it would desync the framed
                # protocol's one-response-per-request contract; but a
                # retiring drainer must not keep consuming either, or a
                # new request for the same client would spawn a SECOND
                # drainer and the two would interleave responses. So:
                # unregister under the lock, then hand any orphaned
                # items to a fresh drainer that takes over the cid.
                with self._state_lock:
                    if self._fifos.get(cid) is not fifo:
                        # replaced or stopped: whoever owns the cid now
                        # (or stop()'s _EOS, already in OUR fifo) drains
                        # the rest — keep looping until we see it
                        continue
                    del self._fifos[cid]
                    del self._drainers[cid]
                    orphans = []
                    try:
                        while True:
                            orphans.append(fifo.get_nowait())
                    except _queue.Empty:
                        pass
                    if orphans:
                        self._adopt_orphans_locked(cid, orphans)
                return
            if item is self._EOS:
                return
            stream, buf, err, t0 = item
            with self._state_lock:
                self._current[cid] = stream
            try:
                if stream is None:  # rejected at intake, in FIFO order
                    self._push_response(self._error_response(buf, err))
                    continue
                toks = stream.result(timeout=timeout)
                reason = stream.finish_reason or ""
                if reason not in ("eos", "length"):
                    # engine-side failure (prefill/dispatch error, engine
                    # stopped): result() returns [] without raising — the
                    # client still gets the documented -1 error response
                    self._push_response(self._error_response(buf, reason))
                    continue
                # the serving analog of the filter's invoke window
                # (tensor_filter.c:325-423): one sample per SUCCESSFUL
                # request — failures must not floor the latency window
                self.request_stats.record(time.monotonic() - t0)
                out = buf.with_tensors(
                    # tokens + the model's per-token logprobs (second
                    # tensor — payload, so it crosses the wire like the
                    # request's budget tensor does)
                    [np.asarray(toks, np.int32),
                     np.asarray(stream.logprobs[:len(toks)],
                                np.float32)]).replace(meta={
                        **buf.meta,
                        "lm_finish_reason": reason,
                        "lm_prompt_len": stream.prompt_len,
                    })
                self._push_response(out)
            except Exception as e:  # noqa: BLE001
                # one failed request
                # must neither kill the drainer nor skip a response (the
                # order-matched protocol would attribute every later
                # completion to the wrong request)
                self.log.warning("client %d request failed: %s", cid, e)
                if stream is not None:
                    # e.g. result() timeout: the client already gets an
                    # error response, so stop the engine from decoding
                    # into the abandoned stream (its slot frees at the
                    # next block boundary); idempotent if already done
                    stream.cancel()
                try:
                    self._push_response(self._error_response(buf, str(e)))
                except Exception as e2:  # noqa: BLE001 — downstream gone
                    self.log.warning("client %d error response dropped: "
                                     "%s", cid, e2)
            finally:
                with self._idle:
                    self._current.pop(cid, None)
                    self._inflight -= 1
                    self._idle.notify_all()

    # -- EOS: drain everything first -----------------------------------------
    def sink_event(self, pad, event):
        if isinstance(event, EosEvent):
            with self._idle:
                done = self._idle.wait_for(
                    lambda: self._inflight == 0,
                    timeout=float(self.get_property("timeout")))
            if not done:
                # late completions will hit an eos'd pad and vanish —
                # stop the engine from decoding into them, and surface
                # WHY those clients never got a response
                self._cancel_all_inflight()
                self.post_error(FlowError(
                    f"{self.name}: EOS with requests still in flight "
                    f"after {self.get_property('timeout')}s; remaining "
                    f"completions will be dropped"))
            super().sink_event(pad, event)
            return
        super().sink_event(pad, event)

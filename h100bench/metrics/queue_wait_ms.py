"""``queue_wait_ms``: the frame ledger's ``queue_wait`` stage
(``obs/timeline.py``; the time frames sit in the pipeline's queues and
the aggregator), mean ms a frame over the frames that reached the sink
in the ledger's slice (the window's last ``run.LEDGER_S`` seconds)."""


def read(ctx):
    ledger = ctx.ledger
    if not ledger or not ledger.get("frames"):
        return None
    return ledger["stages_ms"].get("queue_wait")

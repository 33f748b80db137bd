"""``d2h_ms``: the frame ledger's ``d2h`` stage (the fetch of a frame's
results to the host, ``tensors/buffer.py`` through the
``materialize-host`` queue), mean ms a frame over the frames that reached
the sink in the ledger's slice (the window's last ``run.LEDGER_S``
seconds)."""


def read(ctx):
    ledger = ctx.ledger
    if not ledger or not ledger.get("frames"):
        return None
    return ledger["stages_ms"].get("d2h")

"""The mean time the traced round's arrivals waited in the admission
queue: the drain time less each drained arrival's submit time
(``Arrival.t``, the controller's clock), from the ``admission.round``
span's ``queue_wait_sum_s`` over its ``n_arrivals``.

``traced_round`` finds, for every reader of the program's spans, the
round a traced stretch recorded: the last finished root span of a name
(``repro_torch.telemetry.spans``, which records while the profiler of
``--trace 1`` does) and the spans under it.  A run without a trace, or a
program without spans, gives None."""


def traced_round(ctx, root_name):
    """(root span, the spans under it) of the last ``root_name`` round
    recorded, or None."""
    if ctx["trace"] is None:
        return None
    try:
        from repro_torch.telemetry import spans
    except ImportError:
        return None
    got = spans.finished()
    roots = [s for s in got if s.name == root_name and s.parent_id is None]
    if not roots:
        return None
    return roots[-1], spans.subtree(roots[-1], got)


def read(ctx):
    tree = traced_round(ctx, "admission.round")
    if tree is None:
        return None
    fields = tree[0].fields
    if not fields.get("n_arrivals"):
        return None
    return 1e3 * fields["queue_wait_sum_s"] / fields["n_arrivals"]

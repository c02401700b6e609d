"""Milliseconds the eval entry point's loop waits for the loader's next
batch, per wait: the program's span ``eval.data_wait`` over the traced
window (its wall over its count), as the eval-files loop drains it into
the record under ``program``. Nothing to read where the program has no
such span."""


def read(record):
    summary = (record.get("program") or {}).get("summary", {})
    row = summary.get("eval.data_wait")
    if not row or not row["count"]:
        return None
    return 1e3 * row["wall_s"] / row["count"]

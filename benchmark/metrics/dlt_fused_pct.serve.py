"""The share of a served frame's Jacobi DLT calls on the card that took the
hand-written kernel, in %: 100 x `fused_dlt.launches` / (`fused_dlt.
launches` + `fused_dlt.plain_calls`), the port's counters
(`ops/dlt_jacobi.py`) moved by the traced units (`record["counters"]`).
Left out where neither moved (MvP, which has no DLT)."""


def read(record: dict):
    counters = record.get("counters", {})
    launches = counters.get("fused_dlt.launches", 0)
    plain = counters.get("fused_dlt.plain_calls", 0)
    if launches + plain == 0:
        return None
    return 100.0 * launches / (launches + plain)

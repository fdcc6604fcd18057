"""Front end: per evaluation, the call's host ms less the strata's
(``EvalStats.stratum_seconds``): parse, stratify and the EDB upload."""


def read(records: dict):
    evs = records.get("evaluations") if records.get("kind") == "eval" else None
    if not evs:
        return None
    return sum(e["host_s"] - e["stratum_s"] for e in evs) / len(evs) * 1e3

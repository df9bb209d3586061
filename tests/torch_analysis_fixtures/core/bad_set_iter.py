# ruff: noqa
"""DET004 fixture: hash-seed-dependent set iteration order."""


def collect(ids, skip):
    out = []
    for cid in set(ids) - set(skip):    # line 7: DET004 (for over set)
        out.append(cid)
    ordered = list({3, 1, 2})           # line 9: DET004 (list(set))
    doubled = [c * 2 for c in set(ids)]  # line 10: DET004 (comprehension)
    members = {c for c in set(ids)}     # allowed: set -> set is order-free
    safe = sorted(set(ids))             # allowed: sorted pins the order
    return out, ordered, doubled, members, safe

# ruff: noqa
"""CON002 fixture: record literals diverging from RECORD_SCHEMAS."""

REC_EVENT = "event"

RECORD_SCHEMAS = {
    REC_EVENT: {"required": ["time", "kind"], "optional": ["detail"],
                "open": False},
}


class Recorder:
    def _append(self, rec):
        pass

    def record_event(self, t, extra):
        rec = {"type": REC_EVENT, "time": t}    # line 17: CON002 missing
        rec["surprise"] = extra                 # line 18: CON002 undeclared
        rec["detail"] = "ok"                    # allowed: declared optional
        self._append(rec)

    def record_unknown(self, t):
        self._append({"type": "mystery", "time": t})  # line 23: CON002

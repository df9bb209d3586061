# ruff: noqa
"""DET002 fixture: wall-clock / entropy reads in a simulation path."""
import time
import uuid
from datetime import datetime


def stamp():
    t = time.time()                     # line 9: DET002
    u = uuid.uuid4()                    # line 10: DET002
    d = datetime.now()                  # line 11: DET002
    return t, u, d

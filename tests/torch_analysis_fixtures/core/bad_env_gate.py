# ruff: noqa
"""GATE002 fixture: REPRO_* environment switches (the port has none)."""
import os

FLAG = os.environ.get("REPRO_FIXTURE_FLAG", "0")    # line 5: GATE002
MODE = os.environ["REPRO_FIXTURE_MODE"]             # line 6: GATE002
SWITCH = os.getenv("REPRO_FIXTURE_SWITCH")          # line 7: GATE002
IS_SET = "REPRO_FIXTURE_SET" in os.environ          # line 8: GATE002
HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")  # allowed: not REPRO_*

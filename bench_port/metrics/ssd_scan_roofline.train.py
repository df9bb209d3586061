"""The scan's least time over its kernels' device time in the traced
steps: each call's operations and least bytes at its shape
(flops.ssd_work; the workspace not counted), bound by bf16 or fp32."""
from bench_port import flops

PASSES = ("chunk_state_kernel", "state_pass_kernel", "chunk_output_kernel",
          "ssd_kernel")


def read(run):
    t = run.trace
    if run.kind != "train" or t is None:
        return None
    calls = t.calls.get("ssd_scan", [])
    device_s = t.kernel_s(*PASSES)
    if not calls or device_s <= 0:
        return None
    least = 0.0
    for b, l, h, p, n, size, bc in calls:
        ops, nbytes = flops.ssd_work(b, l, h, p, n, size, bc)
        least += flops.least_s(nbytes, ops, run.part,
                               "bf16" if size == 2 else "fp32")
    return 100.0 * least / device_s

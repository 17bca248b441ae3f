"""The whole training step's share of the card's float32 peak: the
operations of the traced window's episodes (the fused intervals by the
frozen yardstick, the policy's forward every action, the critic over the
episode, and the update's forward and backward every epoch, from the layer
shapes) over the window's seconds on the host's clock at 67 TFLOP/s, in
percent.  It is the traced run's env-steps per second scaled by the
operations an env-step costs: it stays a bound on a kernel's gain when a
later change takes that kernel off the path, and carries nothing that the
trace alone measures."""
from afcbench import yardstick


def read(rec):
    if not rec["episodes"]:
        return None
    flops = (rec["intervals"] * rec["interval_flops"]
             + rec["episodes"] * rec["policy_flops"])
    return 100.0 * flops / (rec["window_s"] * yardstick.PEAK_FP32_FLOPS)

"""The mapping step's share of the card's float32 peak: the operations a
step needs, counted from the traced scene's pairs and shapes
(``generators.mapping.step_flops``), over the window's wall time per step
times 67 TFLOP/s."""
from portbench import peaks


def read(ctx):
    if not ctx.get("counts_per_step") or not ctx.get("wall_per_step_s"):
        return None
    return 100.0 * ctx["counts_per_step"] / (
        ctx["wall_per_step_s"] * peaks.FP32_OPS_PER_S)

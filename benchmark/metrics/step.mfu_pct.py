"""step.mfu_pct: the model operations of every step the window's fits ran
(roofline/counts.step_model_flops: the VGG term's forward and input
gradient, the mesh's products) over the window's wall and the card's
published bf16 peak (989 TFLOP/s), in percent."""

from benchmark.metrics._common import counts, shapes, window_flags

from benchmark.roofline import PEAK_BF16_S


def read(run):
    steps = sum(j.get("steps", 0) for j in run["jobs"])
    if not steps:
        return None
    vgg = window_flags(run)[1] and run["config"].w_vgg > 0
    flops = counts.step_model_flops(shapes(run), run["config"].img_size, vgg,
                                    run["spec"]["model_dims"])
    return 100.0 * steps * flops / run["window_s"] / PEAK_BF16_S

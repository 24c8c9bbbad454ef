"""mfu_pct.eval: the products of one map, counted on the plain reference
at the cell's shapes (FlopCounterMode, 2 per multiply-add), times the
traced window's maps, over the window and the card's dense bf16 peak
(peaks.json, by the card's name)."""


def read(run):
    if (run.kind != "eval" or not run.units or run.peaks is None
            or not run.products_per_unit):
        return None
    return 100 * run.products_per_unit * run.units / run.window_s / run.peaks["bf16_flops"]

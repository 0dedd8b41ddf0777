"""The panel kernel's share of its roofline on the leaf route (one launch a
64-row leaf of a 256-row block), over the window
(:func:`roofline.route_roofline`)."""


def read(ctx):
    return ctx.roofline.route_roofline(ctx, "leaf_lq")

"""The panel kernel's share of its roofline on the block route (one launch
a 128-row block), over the window (:func:`roofline.route_roofline`)."""


def read(ctx):
    return ctx.roofline.route_roofline(ctx, "panel_lq")

"""Mean wall time of one blocked panel solve over the window, from the
server's own histogram ``server/solve_wall_seconds`` (a host clock that
stops once the panel's results are on the host)."""


def read(ctx):
    v = ctx.get("panel_solve_s")
    return None if v is None else 1e3 * v

"""Integrator: rays traced over the render time of the untraced job of
the trace run (Renderer.run_iteration's rays_total and render_s, host
clock around synchronizes), in Mrays/s.  Moves samples_per_s."""


def read(ctx):
    logs = ctx["span_logs"]
    render_s = sum(x["render_s"] for x in logs)
    if not logs or render_s <= 0:
        return None
    return logs[-1]["rays_total"] / render_s / 1e6

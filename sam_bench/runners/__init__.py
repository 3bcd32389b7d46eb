"""Runners: how a traffic mix drives the port. A traffic file names its
runner; each has setup(ctx), window(ctx, seconds), traced(ctx),
release(ctx) and check(ctx)."""

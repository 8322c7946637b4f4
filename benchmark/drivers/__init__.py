"""One driver per entry of the program: ``setup(ctx)``, ``window(ctx,
state)``, ``free(state)`` and ``check(ctx, state)``; a traffic file names
its driver and gives its parameters."""

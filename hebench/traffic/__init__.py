"""Traffic kinds: ``hebench.traffic.<kind>.run(ctx) -> harness.Outcome``.
A mix file (``mixes/<traffic>.json``) names its kind and holds its
parameters; a new kind is one new file here."""

"""Plain references: straightforward PyTorch implementations of the
configurations' semantics.  They import neither ``jax`` nor ``repro`` nor
anything of ``repro_torch``, and take nothing the program made: the harness
hands them the same host inputs it hands the program.  A configuration names
its reference by the module's name (``"reference": {"kind": ...}``)."""

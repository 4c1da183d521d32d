"""Data parallelism of the port: the process group and its helpers
(`distributed`), and the broadcast of one rank's state to every rank
(`mesh.replicate`)."""

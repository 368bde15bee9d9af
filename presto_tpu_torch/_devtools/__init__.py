"""Developer tooling of the port: the runtime lock-order validator."""

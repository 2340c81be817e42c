"""Command-line tools of the port (library functions; the ``accelerate-tpu`` CLI
dispatcher is not ported yet)."""

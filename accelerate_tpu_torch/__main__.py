"""``python -m accelerate_tpu_torch <command>`` → the CLI root (no install needed)."""

from .commands.accelerate_cli import main

if __name__ == "__main__":
    raise SystemExit(main())

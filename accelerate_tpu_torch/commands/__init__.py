"""Command-line tools of the port: each ``*_command_parser`` registers on the CLI root
(``python -m accelerate_tpu_torch <command>``, ``commands/accelerate_cli.py``)."""

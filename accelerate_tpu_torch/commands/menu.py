"""Interactive selection menu of ``python -m accelerate_tpu_torch config``: a copy of
``accelerate_tpu/commands/menu.py``.

On a terminal it draws an arrow-key cursor menu (raw termios, no curses); on a pipe it
asks for a number. Both take the same calls, so the questionnaire runs on scripted input.
"""

from __future__ import annotations

import sys
from typing import Sequence

__all__ = ["BulletMenu", "select", "ask", "ask_bool", "ask_int"]


class BulletMenu:
    """Arrow-key menu: ↑/↓ (or j/k) move, Enter selects, number keys jump."""

    def __init__(self, prompt: str, choices: Sequence[str], default: int = 0):
        self.prompt = prompt
        self.choices = list(choices)
        self.default = default

    # ------------------------------------------------------------------ tty path
    def _read_key(self) -> str:
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setraw(fd)
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # escape sequence (arrows)
                ch += sys.stdin.read(2)
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
        return ch

    def _render(self, cursor: int, first: bool) -> None:
        if not first:
            sys.stdout.write(f"\x1b[{len(self.choices)}A")  # move cursor up n lines
        for i, choice in enumerate(self.choices):
            marker = "➔" if i == cursor else " "
            line = f" {marker} {choice}"
            sys.stdout.write("\x1b[2K" + line + "\n")
        sys.stdout.flush()

    def _run_tty(self) -> int:
        print(self.prompt)
        cursor = self.default
        self._render(cursor, first=True)
        while True:
            key = self._read_key()
            if key in ("\x1b[A", "k"):
                cursor = (cursor - 1) % len(self.choices)
            elif key in ("\x1b[B", "j"):
                cursor = (cursor + 1) % len(self.choices)
            elif key.isdigit() and int(key) < len(self.choices):
                cursor = int(key)
            elif key in ("\r", "\n"):
                return cursor
            elif key in ("\x03", "\x04"):  # ctrl-c / ctrl-d
                raise KeyboardInterrupt
            self._render(cursor, first=False)

    # ----------------------------------------------------------------- pipe path
    def _run_plain(self) -> int:
        print(self.prompt)
        for i, choice in enumerate(self.choices):
            print(f"  [{i}] {choice}")
        raw = input(f"choice [{self.default}]: ").strip()
        if not raw:
            return self.default
        try:
            idx = int(raw)
        except ValueError:
            # Accept the literal choice text too.
            if raw in self.choices:
                return self.choices.index(raw)
            raise ValueError(f"invalid choice {raw!r}")
        if not 0 <= idx < len(self.choices):
            raise ValueError(f"choice {idx} out of range")
        return idx

    def run(self) -> int:
        if sys.stdin.isatty() and sys.stdout.isatty():
            try:
                return self._run_tty()
            except Exception:  # pragma: no cover - exotic terminals
                pass
        return self._run_plain()


def select(prompt: str, choices: Sequence[str], default: int = 0) -> str:
    """Render a menu and return the chosen string."""
    return list(choices)[BulletMenu(prompt, choices, default).run()]


def ask(prompt: str, default, cast=str):
    raw = input(f"{prompt} [{default}]: ").strip()  # noqa: S322 - interactive CLI
    if not raw:
        return default
    return cast(raw)


def ask_bool(prompt: str, default: bool) -> bool:
    raw = input(f"{prompt} [{'yes' if default else 'no'}]: ").strip().lower()
    if not raw:
        return default
    return raw in ("1", "true", "yes", "y")


def ask_int(prompt: str, default: int) -> int:
    return ask(prompt, default, int)

"""Host-side utilities of the port."""
import sys


def emit_line(line: str) -> None:
    """Print one machine-read line in a single write. `print` writes the
    text and its newline apart, so another thread's line (a router's
    supervisor teeing a replica's, a log record on stderr into the same
    pipe) can land between them, and the line no longer starts a line or
    ends after its JSON."""
    sys.stdout.write(line if line.endswith("\n") else line + "\n")
    sys.stdout.flush()

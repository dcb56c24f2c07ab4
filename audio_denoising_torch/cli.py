"""Top-level CLI: ``python -m audio_denoising_torch <command> ...``.

The port's one command so far: ``engine`` (the batched multi-stream
daemon).
"""

import sys

COMMANDS = {
    "engine": "audio_denoising_torch.apps.engine_serve",
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        names = ", ".join(COMMANDS)
        print(f"usage: python -m audio_denoising_torch <command> [...]\n"
              f"commands: {names}")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in COMMANDS:
        import importlib
        return importlib.import_module(COMMANDS[cmd]).main(rest)
    print(f"unknown command {cmd!r}", file=sys.stderr)
    return 2

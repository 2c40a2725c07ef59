"""pgrc — accelerator sequencing-read compression engine (PgRC method).

A from-scratch JAX/XLA implementation of pseudogenome-based read compression:
greedy approximate shortest-common-superstring construction over high-quality
reads, bounded-mismatch alignment of the remaining reads, and per-stream
entropy coding. See DESIGN.md and SURVEY.md.
"""

__version__ = "0.1.0"

ARCHIVE_MAGIC = b"PGTC"
ARCHIVE_VERSION = (1, 0)

from .utils.errors import PgtcFormatError  # noqa: E402,F401  (public API)

# Environment variables the package reads, by the part of their name after
# "PGRC_". Earlier releases spelled them with the former package name's
# second word in between (PGRC_<word>_TRACE); a run that still sets such a
# name is told the current one rather than silently losing the setting.
RENAMED_ENV = {
    "TRACE": "PGRC_TRACE",
    "TWO_PASS": "PGRC_TWO_PASS",
    "RSS_TRACE": "PGRC_RSS_TRACE",
    "JAX_CACHE": "JAX_COMPILATION_CACHE_DIR",
}


def warn_renamed_env(environ=None) -> list[str]:
    """Warn about each set variable of the form PGRC_<word>_<suffix> whose
    suffix the package now reads under another name; returns the warnings."""
    import os
    import warnings

    environ = os.environ if environ is None else environ
    said = []
    for name in sorted(environ):
        head, _, rest = name.partition("_")
        _, _, suffix = rest.partition("_")
        new = RENAMED_ENV.get(suffix)
        if (head == "PGRC" and new is not None
                and name not in RENAMED_ENV.values()):
            said.append(f"{name} is no longer read; set {new} instead")
            warnings.warn(said[-1], stacklevel=2)
    return said


warn_renamed_env()

"""A kernel source as one build of it sees it, for the tests that read the
port's ``csrc/*.cu`` files on a host without nvcc: the ``#if`` / ``#ifdef``
/ ``#ifndef`` / ``#else`` / ``#endif`` blocks whose conditions name only
the given macros are resolved, every other block stays as written.

The physics kernels' variants and builds differ by such blocks
(``FIS_BODY``: B1a's free box, left out in B1d, and B1e's, added to
B1b / B1c; ``FIS_BIAS``: the tree bias); ``FIS_K`` and the dims stay for
the tests to evaluate themselves."""

import os
import re

# the default build of csrc/fused_inner_step.cu: B1a, no bias
DEFAULT = {"FIS_BODY": 1, "FIS_BIAS": 0}
# the default builds of the other sources, where they differ: B1b / B1c
DEFAULTS = {"fused_inner_step_obj.cu": {"FIS_BODY": 0, "FIS_BIAS": 0}}
_DIRECTIVE = re.compile(r"^\s*#\s*(if|ifdef|ifndef|else|endif)\b(.*)$")


def _eval(expr, macros):
    names = set(re.findall(r"[A-Za-z_]\w*", expr)) - {"defined"}
    if not names or not names <= set(macros):
        return None
    py = re.sub(r"!(?!=)", " not ", expr.replace("&&", " and ").replace("||", " or "))
    return bool(eval(re.sub(r"[A-Za-z_]\w*", lambda m: str(macros[m.group(0)]), py)))


def resolve(src: str, macros=None) -> str:
    """``src`` with the conditional blocks on ``macros`` (default
    :data:`DEFAULT`) resolved."""
    macros = DEFAULT if macros is None else macros
    out, stack = [], []                    # frames: [resolved, active, taken]
    live = lambda: all(f[1] for f in stack if f[0])
    for line in src.splitlines():
        m = _DIRECTIVE.match(line)
        if m is None:
            if live():
                out.append(line)
            continue
        kind, rest = m.group(1), m.group(2).split("//")[0].strip()
        if kind in ("if", "ifdef", "ifndef"):
            if kind == "if":
                value = _eval(rest, macros)
            else:
                value = (rest in macros) if rest in macros else None
                if value is not None and kind == "ifndef":
                    value = not value
            if value is None:
                stack.append([False, True, False])
                if live():
                    out.append(line)
            else:
                stack.append([True, value, value])
        elif kind == "else":
            frame = stack[-1]
            if frame[0]:
                frame[1] = not frame[2]
            elif live():
                out.append(line)
        else:
            frame = stack.pop()
            if not frame[0] and live():
                out.append(line)
    return "\n".join(out) + "\n"


def read(path: str, macros=None) -> str:
    """The source at ``path`` as the build with ``macros`` sees it (default:
    that source's default build)."""
    if macros is None:
        macros = DEFAULTS.get(os.path.basename(path), DEFAULT)
    with open(path) as f:
        return resolve(f.read(), macros)

"""Generate roff man pages from the markdown sources in docs/.

The reference installs real ``plssvm-train.1`` / ``plssvm-predict.1`` man
pages (``/root/reference/docs/plssvm-train.1.in``, configured by
``docs/CMakeLists.txt``); this converter builds them without external
tooling (no pandoc): it handles exactly the markdown subset the ``*.1.md``
sources use — ``#``/``##`` headers, ``-``-bullet lists, indented code
blocks, inline ``code``/backslash escapes, paragraphs.

Usage: ``python scripts/gen_man.py`` (writes ``docs/<name>.1`` next to
each ``docs/<name>.1.md``).  Render check: ``man ./docs/plssvm-train.1``.
"""

import datetime
import os
import re
import sys

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "docs")


def _escape(text: str) -> str:
    """Escape roff specials and translate the markdown inline subset."""
    text = text.replace("\\", "\\\\")
    # markdown escapes like \* -> literal *
    text = re.sub(r"\\\\([*_`|])", r"\1", text)
    text = text.replace("-", "\\-")
    # inline code -> bold
    text = re.sub(r"`([^`]*)`", r"\\fB\1\\fR", text)
    if text.startswith("."):
        text = "\\&" + text
    return text


def md_to_roff(md: str, name: str, section: int, version: str) -> str:
    date = datetime.date.today().isoformat()
    out = [f'.TH "{name.upper()}" "{section}" "{date}" '
           f'"plssvm-sparse-fp22 {version}" "User Commands"']
    lines = md.splitlines()
    i = 0
    in_code = False
    while i < len(lines):
        line = lines[i]
        if line.startswith("    ") and not line.lstrip().startswith("- "):
            if not in_code:
                out.append(".nf")
                out.append(".RS 4")
                in_code = True
            out.append(_escape(line[4:]) if line.strip() else "")
            i += 1
            continue
        if in_code and not line.strip():
            # keep blank lines inside a code block if more code follows
            nxt = next((l for l in lines[i + 1:] if l.strip()), "")
            if nxt.startswith("    "):
                out.append("")
                i += 1
                continue
            out.append(".RE")
            out.append(".fi")
            in_code = False
        if in_code:
            out.append(".RE")
            out.append(".fi")
            in_code = False
        if line.startswith("## "):
            out.append(f'.SH "{_escape(line[3:].strip())}"')
        elif line.startswith("# "):
            pass  # page title handled by .TH
        elif line.startswith("- "):
            # gather a bullet (with continuation lines)
            item = [line[2:]]
            i += 1
            while i < len(lines) and lines[i].startswith("  ") and \
                    not lines[i].startswith("    ") and lines[i].strip():
                item.append(lines[i].strip())
                i += 1
            text = " ".join(item)
            # "`flag` — description" -> tagged paragraph
            m = re.match(r"(`[^`]*`(?:\s*/\s*`[^`]*`)*)\s+—\s+(.*)", text)
            out.append(".TP")
            if m:
                out.append(_escape(m.group(1)))
                out.append(_escape(m.group(2)))
            else:
                out.append("\\(bu")
                out.append(_escape(text))
            continue
        elif not line.strip():
            out.append(".PP")
        else:
            out.append(_escape(line))
        i += 1
    if in_code:
        out.append(".RE")
        out.append(".fi")
    # collapse repeated .PP
    collapsed = []
    for l in out:
        if l == ".PP" and collapsed and collapsed[-1] == ".PP":
            continue
        collapsed.append(l)
    return "\n".join(collapsed) + "\n"


def main():
    sys.path.insert(0, os.path.dirname(DOCS))
    from plssvm_sparse_fp22.version import VERSION as __version__

    wrote = []
    for fname in sorted(os.listdir(DOCS)):
        m = re.match(r"(.+)\.(\d)\.md$", fname)
        if not m:
            continue
        name, section = m.group(1), int(m.group(2))
        with open(os.path.join(DOCS, fname)) as fh:
            md = fh.read()
        roff = md_to_roff(md, name, section, __version__)
        out_path = os.path.join(DOCS, f"{name}.{section}")
        with open(out_path, "w") as fh:
            fh.write(roff)
        wrote.append(out_path)
    print("wrote:", *wrote, sep="\n  ")


if __name__ == "__main__":
    main()

"""What the compiler made of the CUDA sweep kernel, per template
instantiation: ptxas's registers, stack frame and spills, the SASS
instruction count (code size) and local-memory loads and stores, and the
same for a diagnosis build with sincosf replaced by __sincosf (whose
range reduction has no slow path, so a stack frame that goes away with it
is sincosf's slow-path scratch).  Needs nvcc and cuobjdump (the CUDA
toolkit); no card.

    python scripts/probe_sweep_kernel_sass.py [other_sweep_kernel.cu ...]

compares the repo's csrc/sweep_kernel.cu with other versions of it (for
example the parent commit's, from `git show`).  Writes its builds under a
temporary directory and prints one line per instantiation.
"""

import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "metropolismontecarlo_tpu_torch" / "csrc" / "sweep_kernel.cu"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
LABELS = {"ILb0ELb0ELb0E": "fixed N", "ILb1ELb0ELb0E": "activity",
          "ILb1ELb1ELb0E": "tmmc", "ILb0ELb0ELb1E": "global layout"}


def tool(name):
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and pathlib.Path(cand).exists():
            return cand
    raise SystemExit(f"{name} not found: this probe needs the CUDA toolkit")


def label(text):
    return next((v for k, v in LABELS.items() if k in text), None)


def probe(src, out):
    cubin = out.with_suffix(".cubin")
    res = subprocess.run([tool("nvcc"), *FLAGS, "-Xptxas", "-v", "-cubin",
                          "-o", str(cubin), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{res.stderr}")
    rows, entry = {}, None
    for line in res.stderr.splitlines():
        if "Compiling entry function" in line:
            entry = label(line)
        elif entry and "stack frame" in line:
            rows[entry] = [int(v) for v in re.findall(r"(\d+) bytes", line)]
        elif entry and "registers" in line:
            rows[entry].append(int(re.search(r"(\d+) registers",
                                             line).group(1)))
    sass = subprocess.run([tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        name = label(part.splitlines()[0])
        lines = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(.*)$", part, re.M)
        local = sum(1 for s in lines if re.search(r"\b(LDL|STL)\b", s))
        rows[name] += [len(lines), local]
    return rows


def main():
    sources = [SOURCE] + [pathlib.Path(p) for p in sys.argv[1:]]
    with tempfile.TemporaryDirectory() as tmp:
        for i, src in enumerate(sources):
            fast = pathlib.Path(tmp) / f"fast_sincos_{i}.cu"
            fast.write_text(re.sub(r"\bsincosf\(", "__sincosf(",
                                   src.read_text()))
            for tag, path in (("as built", src), ("__sincosf", fast)):
                rows = probe(path, pathlib.Path(tmp) / f"{i}_{tag[:2]}")
                for name in LABELS.values():
                    frame, st, ld, regs, n_ins, n_local = rows[name]
                    print(f"{src.name} ({tag}) {name}: {regs} registers, "
                          f"{frame} B stack frame, spills {st} B stored / "
                          f"{ld} B loaded, {n_ins} SASS instructions "
                          f"({16 * n_ins} B), {n_local} local loads and "
                          f"stores")


if __name__ == "__main__":
    main()

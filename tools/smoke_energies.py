"""The energies of two ``chip_smoke.py`` logs, phase by phase, and
whether they are bit-equal.

    python tools/smoke_energies.py PARENT.log NEW.log

Reads the phase lines (one JSON object per line, ``{"phase": ...}``) of
each log and every ``energy_per_boson`` (and ``R2_energy_per_boson``)
value in them, nested ones included (a sweep's rows), keyed by phase,
check and path.  Prints one line per key with both values and whether
they are equal, keys found in one log only marked as such, and a last
line with the counts.  Exits 1 if any shared key differs.  Runs
anywhere (the standard library only).
"""
import json
import sys

KEYS = ("energy_per_boson", "R2_energy_per_boson")


def energies(path: str) -> dict:
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for key, value in node.items():
                if key in KEYS and isinstance(value, (int, float)):
                    out[prefix + (key,)] = value
                else:
                    walk(value, prefix + (key,))
        elif isinstance(node, list):
            for i, value in enumerate(node):
                walk(value, prefix + (str(i),))

    seen = {}
    with open(path) as fp:
        for line in fp:
            if not line.startswith('{"phase"'):
                continue
            record = json.loads(line)
            head = (record["phase"], record.get("check", ""))
            # A phase may print several lines of one check (U's chains).
            seen[head] = seen.get(head, -1) + 1
            walk(record, head + (str(seen[head]),))
    return out


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    old, new = energies(sys.argv[1]), energies(sys.argv[2])
    differ = 0
    for key in sorted(set(old) | set(new)):
        name = " / ".join(key)
        if key not in old or key not in new:
            where = "new only" if key in new else "parent only"
            print(f"{name}: {old.get(key, new.get(key))!r} ({where})")
            continue
        same = old[key] == new[key]
        differ += not same
        print(f"{name}: {old[key]!r} {new[key]!r} "
              f"{'bit-equal' if same else 'DIFFERENT'}")
    shared = len(set(old) & set(new))
    print(f"shared {shared}, bit-equal {shared - differ}, different "
          f"{differ}, new only {len(set(new) - set(old))}, parent only "
          f"{len(set(old) - set(new))}")
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()

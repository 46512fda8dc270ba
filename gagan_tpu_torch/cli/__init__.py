"""Command-line entry points of the port."""


def num_range(s: str):
    """Parse '1,2,5-10' into a list of ints."""
    import re

    ranges = []
    for part in s.split(","):
        m = re.match(r"^(\d+)-(\d+)$", part)
        if m:
            ranges.extend(range(int(m.group(1)), int(m.group(2)) + 1))
        else:
            ranges.append(int(part))
    return ranges

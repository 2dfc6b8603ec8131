"""Sequence-index CSV builder (own copy of
``deepsense6g_tii_tpu/data/preprocess/csv_builder.py``: the same tree gives
the same bytes).

It replaces the original ``createdata_seq.py``: scans the scenario
directories, aligns camera/radar/LiDAR ids (stride 2) with GPS ids (stride
6), takes the best beam per future step as the argmax of the mmWave power
file, skips samples with id gaps >= 10, and writes the root CSV (plus
per-scenario filtered CSVs).

    python -m deepsense6g_tii_tpu_torch.data.preprocess.csv_builder \\
        ROOT ml_challenge_dev_multi_modal.csv [--seq_len 5] [--pred_len 1]
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence


def create_row_head(seq_len: int, pred_len: int) -> List[str]:
    head = ["index"]
    for c in ("unit1_rgb", "unit1_radar", "unit1_lidar"):
        head += [f"{c}_{i}" for i in range(1, seq_len + 1)]
    head.append("unit1_loc")
    head += [f"unit2_loc_{i}" for i in (1, 2)]
    head += [f"unit1_pwr_60ghz_{j}" for j in range(1, pred_len + 1)]
    head.append("unit1_beam")
    return head


def list2dict(names: Sequence[str]) -> Dict[int, str]:
    """id -> filename for ids parsed as the trailing _<id> integer
    (createdata_seq.py:22-28)."""
    out = {}
    for name in names:
        if name.endswith((".jpg", ".npy", ".ply", ".txt")):
            try:
                out[int(name.split(".")[0].split("_")[-1])] = name
            except ValueError:
                continue
    return out


def get_beam_label(beam_paths: Sequence[str], root: str) -> str:
    """argmax of each power file, 1-indexed, '_'-joined.

    Parity note: the reference takes ``max(f.readlines())`` — a *string*
    max over the text lines (createdata_seq.py:30-39).  We reproduce that
    exactly so generated labels match byte-for-byte.
    """
    labels = []
    for p in beam_paths:
        with open(os.path.join(root, p)) as f:
            lines = f.readlines()
        labels.append(str(lines.index(max(lines)) + 1))
    return "_".join(labels)


def create_root_csv(root_path: str, output_file: str, seq_len: int,
                    pred_len: int,
                    scenario_list: Sequence[str] = None) -> int:
    """Writes ``output_file`` under ``root_path``; returns rows written."""
    if scenario_list is None:
        if "dev_multi_modal" in output_file:
            scenario_list = ["scenario32", "scenario33", "scenario34"]
        elif "data_adaptation_multi_modal" in output_file:
            scenario_list = ["scenario31", "scenario32", "scenario33"]
        else:
            raise ValueError("pass scenario_list explicitly")

    out_path = os.path.join(root_path, output_file)
    rows = []
    index = 1
    for scen in scenario_list:
        def ls(*parts):
            return os.listdir(os.path.join(root_path, scen, *parts))

        cam = list2dict(ls("unit1", "camera_data"))
        rad = list2dict(ls("unit1", "radar_data"))
        lid = list2dict(ls("unit1", "lidar_data"))
        gps2 = list2dict(ls("unit2", "GPS_data"))
        beam = list2dict(ls("unit1", "mmWave_data"))
        beam_id = sorted(beam.keys())

        valid = beam_id[:-pred_len][seq_len * 2:]
        gps_u1 = f"./{scen}/unit1/GPS_data/gps_location.txt"
        for bid in valid:
            ok = True
            cams, rads, lids, gpss, beams = [], [], [], [], []
            frame_ids = list(range(bid, bid - 2 * seq_len, -2))[::-1]
            for fid in frame_ids:
                if fid in cam and fid in rad and fid in lid:
                    cams.append(f"./{scen}/unit1/camera_data/{cam[fid]}")
                    rads.append(f"./{scen}/unit1/radar_data/{rad[fid]}")
                    lids.append(f"./{scen}/unit1/lidar_data/{lid[fid]}")
                else:
                    ok = False
            for gid in list(range(bid - 6, bid - 18, -6))[::-1]:
                if gid in gps2:
                    gpss.append(f"./{scen}/unit2/GPS_data/{gps2[gid]}")
                else:
                    ok = False
            bi = beam_id.index(bid)
            if beam_id[bi + pred_len] - beam_id[bi] < 10:
                for pid in beam_id[bi:bi + pred_len]:
                    beams.append(f"./{scen}/unit1/mmWave_data/{beam[pid]}")
            else:
                ok = False
            if not ok:
                continue
            label = get_beam_label(beams, root_path)
            rows.append([index] + cams + rads + lids + [gps_u1] + gpss
                        + beams + [label])
            index += 1

    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(create_row_head(seq_len, pred_len))
        w.writerows(rows)
    return len(rows)


def create_scenario_csv(input_csv: str, output_stem: str,
                        keyword: str) -> int:
    """Filters rows whose 2nd column contains ``keyword``
    (createDataset, createdata_seq.py:145-162 / train2_seq.py:442-455)."""
    n = 0
    with open(input_csv) as fin, open(output_stem + ".csv", "w",
                                      newline="") as fout:
        reader = csv.DictReader(fin)
        writer = csv.DictWriter(fout, fieldnames=reader.fieldnames)
        writer.writeheader()
        for row in reader:
            if keyword in row[reader.fieldnames[1]]:
                writer.writerow(row)
                n += 1
    return n


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root_path")
    p.add_argument("output_file")
    p.add_argument("--seq_len", type=int, default=5)
    p.add_argument("--pred_len", type=int, default=1)
    p.add_argument("--scenarios", nargs="*", default=None)
    a = p.parse_args(argv)
    n = create_root_csv(a.root_path, a.output_file, a.seq_len, a.pred_len,
                        a.scenarios)
    print(f"wrote {n} rows to {a.output_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

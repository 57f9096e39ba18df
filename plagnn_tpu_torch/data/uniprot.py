"""UniProt localization-annotation extraction.

Port of ``plagnn_tpu/data/uniprot.py`` (numpy, scipy, gzip and json only,
so a copy), which reproduces the reference's data_preprocess.py:333-472:
scan ``uniprot_sprot_human.dat.gz`` entries, keep ``DR   GO;`` lines with
a cellular-component (``C:``) annotation whose evidence code is one of
IDA/HDA/IEA/EXP/IPI and whose GO id is in the 12-term cellular_component
list; build the (N, 12) localization matrix and the annotated-protein
index list (the CV universe).
"""
from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

_EVIDENCE = ("IDA", "HDA", "IEA", "EXP", "IPI")


def judge_gene_onthology_line(line: str, go_list: Sequence[str]) -> bool:
    """Exact filter of data_preprocess.py:333-349 (including the [9:19] GO-id
    slice convention)."""
    return (
        line.startswith("DR   GO;")
        and "C:" in line
        and any(ev in line for ev in _EVIDENCE)
        and line[9:19] in go_list
    )


def extract_localization_data(
    uniprot_sprot_path: str,
    cellular_component_path: str,
    protein_list: Sequence[str],
) -> List[Tuple[str, List[str]]]:
    """label_list: [(uniprot_ac, [GO ids...])] for every PPI protein
    (data_preprocess.py:352-399)."""
    with gzip.open(uniprot_sprot_path) as f:
        data = f.read().decode()
    entry_list = data.split("//\n")[0:-1]

    with open(cellular_component_path) as f:
        loc_list = f.read().split()

    uni_set = set(protein_list)
    loc_dict: Dict[str, List[str]] = {}
    for entry in entry_list:
        ac, cc_list = None, []
        for line in entry.split("\n"):
            if not ac:
                if line.startswith("AC"):
                    ac = line.split()[1].replace(";", "")
            elif judge_gene_onthology_line(line, loc_list):
                cc_list.append(line[9:19])
        if ac in uni_set and cc_list:
            loc_dict[ac] = cc_list

    return [(u, loc_dict.get(u, [])) for u in protein_list]


def construct_protein_loc_matrix(
    label_list: List[Tuple[str, List[str]]],
    cellular_component_path: str,
) -> sp.coo_matrix:
    """(N, 12) binary COO localization matrix (data_preprocess.py:402-435)."""
    with open(cellular_component_path) as f:
        loc_list = f.read().split()
    col_of = {go: c for c, go in enumerate(loc_list)}
    rows, cols = [], []
    for r, (_, gos) in enumerate(label_list):
        for go in gos:
            rows.append(r)
            cols.append(col_of[go])
    return sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)),
        shape=(len(label_list), len(loc_list)),
    )


def extract_data_with_position(label_list) -> List[int]:
    """Indices of annotated proteins -- label_with_loc_list
    (data_preprocess.py:457-472)."""
    return [i for i, (_, gos) in enumerate(label_list) if gos]


def construct_loc_matrix(
    uniprot_sprot_path: str,
    cellular_component_path: str,
    protein_list: Sequence[str],
    out_dir: str,
) -> None:
    """Functional integration + artifact store (data_preprocess.py:438-454):
    loc_matrix.npz, label_list.json, label_with_loc_list.json."""
    label_list = extract_localization_data(
        uniprot_sprot_path, cellular_component_path, protein_list
    )
    loc_matrix = construct_protein_loc_matrix(label_list, cellular_component_path)
    label_with_loc = extract_data_with_position(label_list)

    sp.save_npz(os.path.join(out_dir, "loc_matrix"), loc_matrix.tocoo())
    with open(os.path.join(out_dir, "label_with_loc_list.json"), "w") as f:
        json.dump(label_with_loc, f)
    with open(os.path.join(out_dir, "label_list.json"), "w") as f:
        json.dump(label_list, f)

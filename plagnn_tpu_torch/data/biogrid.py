"""BioGRID mitab ingestion -> PPI adjacency.

Port of ``plagnn_tpu/data/biogrid.py`` (numpy, scipy and the standard
library only, so a copy), which re-implements the reference's interaction
extraction (data_preprocess.py:21-125) with identical filtering semantics:
the interaction-type column must contain MI codes 0915 (physical
association), 0407 (direct interaction) or 0403 (colocalization);
swiss-prot accessions parsed from the alt-ID columns; symmetric edge set;
sorted accession list; zeroed diagonal; one streaming pass.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

_MI_CODES = ("0915", "0407", "0403")


def _swissprot_acs(field: str) -> List[str]:
    """Accessions from 'uniprot/swiss-prot:P12345|...' sub-fields
    (data_preprocess.py:41-51 parse: split on 'uniprot', then ':' and '|')."""
    parts = field.split("uniprot")
    if len(parts) == 1:
        return []
    acs = []
    for p in parts:
        if "/swiss-prot:" in p:
            acs.append(p.split(":")[1].split("|")[0])
    return acs


def extract_interaction_data(data_file: str) -> Dict[str, list]:
    """Streaming mitab scan (semantics of data_preprocess.py:21-71)."""
    uniprot_ids = set()
    interactions = set()
    with open(data_file) as f:
        next(f)  # header
        for line in f:
            cols = line.split("\t")
            if len(cols) < 12:
                continue
            itype = cols[11]
            if not any(code in itype for code in _MI_CODES):
                continue
            uid_1 = _swissprot_acs(cols[2])
            uid_2 = _swissprot_acs(cols[3])
            if not uid_1 or not uid_2:
                continue
            for i1 in uid_1:
                for i2 in uid_2:
                    if i1 == i2:
                        continue
                    uniprot_ids.add(i1)
                    uniprot_ids.add(i2)
                    interactions.add((i1, i2))
                    interactions.add((i2, i1))
    return {
        "id_list": sorted(uniprot_ids),
        "interaction_list": list(interactions),
    }


def construct_uniprot_ppi(
    uniprot_list: List[str], interaction_list: List[Tuple[str, str]]
) -> sp.coo_matrix:
    """Symmetric 0/1 COO adjacency, zero diagonal
    (data_preprocess.py:74-110)."""
    idx = {u: i for i, u in enumerate(uniprot_list)}
    n = len(uniprot_list)
    if interaction_list:
        a = np.fromiter(
            (idx[i] for i, _ in interaction_list), np.int64, len(interaction_list)
        )
        b = np.fromiter(
            (idx[j] for _, j in interaction_list), np.int64, len(interaction_list)
        )
        pairs = np.unique(
            np.stack([np.concatenate([a, b]), np.concatenate([b, a])], 1), axis=0
        )
        keep = pairs[:, 0] != pairs[:, 1]
        pairs = pairs[keep]
        ppi = sp.coo_matrix(
            (np.ones(len(pairs), np.int64), (pairs[:, 0], pairs[:, 1])),
            shape=(n, n),
        )
    else:
        ppi = sp.coo_matrix((n, n), dtype=np.int64)
    return ppi


def construct_normal_ppi(data_file: str) -> Tuple[sp.coo_matrix, List[str]]:
    """(PPI coo, sorted accession list) -- data_preprocess.py:113-125."""
    d = extract_interaction_data(data_file)
    return construct_uniprot_ppi(d["id_list"], d["interaction_list"]), d["id_list"]

"""A cell cut to a size that a CPU test run holds: the cell's configuration
and traffic with a few hundred nodes, 3 folds and 10-epoch rounds."""
from gpubench.harness import Cell, load_cell


def tiny_cell(name: str = "gnn32_ppi24k") -> Cell:
    cell = load_cell(name)
    cell.traffic = dict(cell.traffic, nodes=300, edges=2400, fold_batch=3, stretch_epochs=4)
    cell.config = dict(cell.config, fold_num=5, epoch_num=10)
    return cell

"""repro_torch.core: triplet and CSC containers, the numpy oracle and the
paper's data sets (counterpart of ``repro.core``)."""

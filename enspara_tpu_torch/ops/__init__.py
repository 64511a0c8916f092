"""QCP RMSD, the k-centers and all-pairs RMSD kernels, and the sparse
operands and ELL SpMM kernel of the eigensolver."""

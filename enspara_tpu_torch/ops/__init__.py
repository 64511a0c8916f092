"""QCP RMSD and the k-centers kernel."""

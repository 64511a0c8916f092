from .topology import Topology, Atom, Residue, Chain, ELEMENT_RADII
from .trajectory import Trajectory, load, load_frame, join
from .pdb import load_pdb, write_pdb
from .xtc import load_xtc, write_xtc, scan_xtc
from .hdf5 import load_hdf5, write_hdf5
from .dcd import load_dcd, write_dcd
from .trr import load_trr, write_trr
from .netcdf import load_netcdf, write_netcdf
from .gro import load_gro, write_gro

"""Keras model import (counterpart of `deeplearning4j_tpu/modelimport/`).

HDF5 access goes through the port's C++ shim `native/hdf5/dl4j_hdf5.cpp`
(ctypes -> the shim -> the host's libhdf5), as deeplearning4j-modelimport
binds libhdf5 through JavaCPP in `Hdf5Archive.java`.
"""

from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport

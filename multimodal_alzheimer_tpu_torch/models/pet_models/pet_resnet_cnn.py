"""PET classifier on the Med3D ResNet backbone (PET_CNN_ResNet parity).

Port of ``multimodal_alzheimer_tpu/models/pet_models/pet_resnet_cnn.py``
(reference: pkg/models/pet_models/pet_resnet_cnn.py:15-92): ``AnatCNN``'s
backbone and head reading the PET volume, batch key 'pet1451'. Its stem pool
takes ``maxpool_impl`` as ``AnatCNN`` does; ``models/convert.py`` maps its
weights with ``AnatCNN``'s names.
"""

from __future__ import annotations

from multimodal_alzheimer_tpu_torch.models.mri_models.anat_cnn import AnatCNN


class PETResNetCNN(AnatCNN):
    def __init__(self, *args, input_key: str = "pet1451", **kwargs):
        super().__init__(*args, input_key=input_key, **kwargs)

from vkrt_tpu_torch.scene.model import Model, Submesh, Material, Image
from vkrt_tpu_torch.scene.gltf import load_model
from vkrt_tpu_torch.scene.flatten import FlatScene, flatten_model
from vkrt_tpu_torch.scene.textures import TextureHeap, build_texture_heap

__all__ = [
    "Model", "Submesh", "Material", "Image", "load_model",
    "FlatScene", "flatten_model", "TextureHeap", "build_texture_heap",
]

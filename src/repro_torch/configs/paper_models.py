"""The paper's own experiment models (Section 8.1): VGG-19 and ResNet-152,
as analytic layer-cost tables for the allocator/partitioner (batch 32,
ImageNet 224x224, as in the paper; a copy of repro.configs.paper_models)."""
from repro_torch.models.cnn import resnet152_layer_costs, vgg19_layer_costs

PAPER_MODEL_COSTS = {
    "vgg19": vgg19_layer_costs,        # 548 MB params — comm-heavy DP
    "resnet152": resnet152_layer_costs,  # 230 MB params — compute-heavy
}

"""Models (ports of ``aip_tpu.models``): the AdaIN encoder and decoder, the
depth proxy, magenta and MobileNetV2, the segmenters (classical, DeepLabV3-
ResNet101 on ResNet blocks), the ImageNet VGG-19, the LPIPS backbones, and
the style mixer's DenseNet-121 and Swin-T."""

"""The segmentation trainer that the generator feeds: the UNet
(:mod:`.unet`), the fused generate-and-train step (:mod:`.step`) and its
command-line entry point (:mod:`.segmentation`)."""

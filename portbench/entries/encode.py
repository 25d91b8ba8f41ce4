"""`models.codec.encode`: one call per image of the request, in turn."""


def make(config, device):
    from roibasedimagecompression_torch.models import codec

    def call(images):
        return [codec.encode(img, config, device) for img in images]

    return call

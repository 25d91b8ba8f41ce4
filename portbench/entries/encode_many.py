"""`parallel.stream.encode_many`: one call encodes the whole request."""


def make(config, device):
    from roibasedimagecompression_torch.parallel import stream

    def call(images):
        return stream.encode_many(images, config, device)

    return call

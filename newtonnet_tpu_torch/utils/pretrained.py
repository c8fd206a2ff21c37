'''Pretrained checkpoint registry (the JAX package's `utils/pretrained.py`;
reference: newtonnet/utils/pretrained_models.py).

The published NewtonNet release artifacts are zip archives of torch-pickled
models; the archive layout (``newtonnet_<name>/models/best_model.pt``) is
fixed by the upstream release. This module fetches an archive into a local
cache and returns the checkpoint path; ``utils.torch_import`` loads the
pickle into a port model. The cache root is the JAX package's, so either
package finds a checkpoint the other unpacked.

Environments without network access get an actionable error instead of a
bare URLError -- point ``pretrained_model.path`` at a local ``.pt`` file.
'''
import os
import zipfile
from urllib.request import urlretrieve

# release zips published by the upstream project (the artifact registry)
URLS = {
    'ani1': 'https://github.com/THGLab/NewtonNet/releases/download/pretrained/newtonnet_ani1.zip',
    'ani1x': 'https://github.com/THGLab/NewtonNet/releases/download/pretrained/newtonnet_ani1x.zip',
    't1x': 'https://github.com/THGLab/NewtonNet/releases/download/pretrained/newtonnet_t1x.zip',
}

CACHE_ROOT = os.path.expanduser('~/.cache/newtonnet_tpu')


def checkpoint_path(model: str) -> str:
    '''Local path where the unpacked checkpoint for `model` lives.'''
    return os.path.join(CACHE_ROOT, f'newtonnet_{model}', 'models',
                        'best_model.pt')


def download_checkpoint(model: str) -> str:
    '''Fetch (or find cached) a published checkpoint; returns its .pt path.

    `model` is a registry key ('ani1' | 'ani1x' | 't1x') or a direct URL.
    '''
    target = checkpoint_path(model)
    if os.path.exists(target):
        return target

    url = URLS.get(model, model)
    os.makedirs(CACHE_ROOT, exist_ok=True)
    archive = os.path.join(CACHE_ROOT, f'newtonnet_{model}.zip')
    print(f'fetching pretrained weights "{model}" <- {url}')
    try:
        _, headers = urlretrieve(url, archive)
    except OSError as e:
        raise RuntimeError(
            f'unable to reach {url} (no network access?). Fetch the archive '
            f'on a connected machine and pass its best_model.pt path via '
            f'pretrained_model.path instead.') from e
    if 'text/html' in str(headers.get_content_type()
                          if hasattr(headers, 'get_content_type')
                          else headers):
        raise RuntimeError(
            f'{url} returned an HTML page, not a zip archive -- the release '
            f'URL may have moved; check the registry key {model!r}')
    with zipfile.ZipFile(archive) as zf:
        zf.extractall(CACHE_ROOT)
    os.remove(archive)
    print(f'pretrained weights unpacked at {target}')
    return target
